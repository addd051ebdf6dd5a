"""File helpers (the part of ``hero_tpu/utils/basic_utils.py`` the drivers
need)."""

from __future__ import annotations

import os
import zipfile


def make_zipfile(src_dir: str, save_path: str, exclude_dirs=()) -> None:
    """Zip the tree under ``src_dir`` (the code's snapshot where git is
    absent), leaving out directories named in ``exclude_dirs``."""
    src = os.path.abspath(src_dir)
    with zipfile.ZipFile(save_path, "w") as zf:
        for dirname, subdirs, files in os.walk(src):
            subdirs[:] = [d for d in subdirs if d not in exclude_dirs]
            for filename in files:
                path = os.path.join(dirname, filename)
                zf.write(path, os.path.relpath(path, src))
