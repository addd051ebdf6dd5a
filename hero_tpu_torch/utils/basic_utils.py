"""File helpers (a copy of ``hero_tpu/utils/basic_utils.py``; reference
``utils/basic_utils.py``): json, jsonl and pickle files, splitting an
array by lengths, the TVR show of a video, and the code snapshot."""

from __future__ import annotations

import json
import os
import pickle
import zipfile
from typing import Any, Iterable, List


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def save_json(data: Any, path: str, save_pretty: bool = False,
              sort_keys: bool = False) -> None:
    with open(path, "w") as f:
        if save_pretty:
            f.write(json.dumps(data, indent=4, sort_keys=sort_keys))
        else:
            json.dump(data, f, sort_keys=sort_keys)


def load_jsonl(path: str) -> List[Any]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def save_jsonl(data: Iterable[Any], path: str) -> None:
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(e) for e in data))


def load_pickle(path: str) -> Any:
    """Unpickle ``path``; only for files this program or its tools wrote
    (unpickling runs code)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(data: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)


def dissect_by_lengths(np_array, lengths, dim: int = 0,
                       assert_equal: bool = True):
    """Split an array along ``dim`` (0 or 1) into chunks of ``lengths``;
    with ``assert_equal`` the lengths must sum to the axis."""
    if assert_equal and np_array.shape[dim] != sum(lengths):
        raise ValueError(f"lengths sum to {sum(lengths)}, the axis holds "
                         f"{np_array.shape[dim]}")
    if dim not in (0, 1):
        raise NotImplementedError(f"dim {dim}")
    out, offset = [], 0
    for n in lengths:
        out.append(np_array[offset:offset + n] if dim == 0
                   else np_array[:, offset:offset + n])
        offset += n
    return out


def get_show_name(vid_name: str) -> str:
    """The show of a TVR video name ({show}_{season}_...); "bbt" for the
    names without a show prefix."""
    show_list = ["friends", "met", "castle", "house", "grey"]
    vid_name_prefix = vid_name.split("_")[0]
    return vid_name_prefix if vid_name_prefix in show_list else "bbt"


def make_zipfile(src_dir: str, save_path: str, enclosing_dir: str = "",
                 exclude_dirs=(), exclude_extensions=(),
                 exclude_dirs_substring=None) -> None:
    """Zip the tree under ``src_dir`` (the code's snapshot where git is
    absent) below ``enclosing_dir`` in the archive, each directory an
    entry of its own, leaving out directories named in ``exclude_dirs``
    (and what is below them), the files of a directory whose path holds
    ``exclude_dirs_substring``, and files whose extension is in
    ``exclude_extensions`` (``hero_tpu/utils/basic_utils.py:68-90``)."""
    src = os.path.abspath(src_dir)
    with zipfile.ZipFile(save_path, "w") as zf:
        for dirname, subdirs, files in os.walk(src):
            if exclude_dirs_substring is not None and \
                    exclude_dirs_substring in dirname:
                continue
            subdirs[:] = [d for d in subdirs if d not in exclude_dirs]
            arcname = os.path.join(enclosing_dir, dirname[len(src) + 1:])
            zf.write(dirname, arcname)
            for filename in files:
                if os.path.splitext(filename)[1] in exclude_extensions:
                    continue
                zf.write(os.path.join(dirname, filename),
                         os.path.join(arcname, filename))
