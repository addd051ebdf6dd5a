"""Recommend ``--bucket_*`` flags for a corpus, unpacked or packed (the
port's ``tools/suggest_bucket.py``).  The drivers take the flags
(``config/opts.py``); the bucket is sized from the corpus' shape
statistics (the prepro sidecar ``vid2sub_len.json`` where present, else
one scan of the store):

    # pretraining / VCMR sub bucket
    python -m hero_tpu_torch.prepro.suggest_bucket --sub_txt_db DB \\
        --max_txt_len 60 --sub_ctx_len 1 --coverage 0.99 [--pack]

    # downstream task budgets (QA / statement / caption / clip lengths)
    python -m hero_tpu_torch.prepro.suggest_bucket --task tvqa \\
        --query_txt_db QA_DB --sub_txt_db DB [--pack]
    python -m hero_tpu_torch.prepro.suggest_bucket --task violin \\
        --query_txt_db VIOLIN_DB
    python -m hero_tpu_torch.prepro.suggest_bucket --task tvc \\
        --cap_db TVC_ROOT

Unpacked, the bucket is each dimension's coverage quantile
(``data/video.suggest_shapes``); ``--pack`` searches (rows x text x
frames) for the cheapest bucket into which the first-fit packer puts
>= coverage of the videos whole (``data/video.suggest_packed_shapes``).
For QA and VIOLIN the appended question or statement budget joins the
text budget of each row (or packed segment), since every one carries a
copy.  Prints the flags as one JSON line on stdout and as a command line
on stderr."""

from __future__ import annotations

import argparse
import json
import sys

from hero_tpu_torch.data.downstream_tasks import suggest_downstream_lens
from hero_tpu_torch.data.store import SubTokStore
from hero_tpu_torch.data.video import (FixedShapes, suggest_packed_shapes,
                                       suggest_shapes)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="suggest --bucket_* flags for a corpus")
    ap.add_argument("--sub_txt_db", default=None)
    ap.add_argument("--task", default="pretrain",
                    help="pretrain (sub bucket only) | tvqa/how2qa | "
                         "violin | tvc: downstream tasks also size "
                         "their qa/statement/caption budgets")
    ap.add_argument("--query_txt_db", default=None,
                    help="QA/VIOLIN query db (qa_len / stmt_len source)")
    ap.add_argument("--cap_db", default=None,
                    help="TVC caption db root (cap_len/seg_len/"
                         "clips_per_item source)")
    ap.add_argument("--max_clip_len", type=int, default=100)
    ap.add_argument("--max_txt_len", type=int, default=60)
    ap.add_argument("--sub_ctx_len", type=int, default=0)
    ap.add_argument("--vfeat_interval", type=float, default=1.5)
    ap.add_argument("--coverage", type=float, default=0.99,
                    help="fraction of videos the bucket must hold "
                         "untruncated (the rest route to "
                         "--second_bucket)")
    ap.add_argument("--pack", action="store_true",
                    help="size a --pack_subs bucket (rows hold several "
                         "subs) instead of one-sub-per-row")
    return ap


def suggest(a) -> dict:
    """The flags of the parsed arguments ``a``."""
    flags = {}
    append_len = 0
    if a.task in ("tvqa", "how2qa", "videoqa", "violin"):
        if not a.query_txt_db:
            raise SystemExit(f"--task {a.task} needs --query_txt_db")
        flags.update(suggest_downstream_lens(a.task, a.query_txt_db,
                                             coverage=a.coverage))
        append_len = flags["bucket_query_len"]
    elif a.task == "tvc":
        if not a.cap_db:
            raise SystemExit("--task tvc needs --cap_db")
        flags.update(suggest_downstream_lens(
            a.task, a.cap_db, coverage=a.coverage,
            frame_interval=a.vfeat_interval, max_clip_len=a.max_clip_len))
    if a.sub_txt_db:
        sub = SubTokStore(a.sub_txt_db, max_clip_len=a.max_clip_len)
        fn = suggest_packed_shapes if a.pack else suggest_shapes
        sp = fn(sub, coverage=a.coverage, max_txt_len=a.max_txt_len,
                sub_ctx_len=a.sub_ctx_len, base=FixedShapes(n_frames=8),
                append_len=append_len)
        flags.update({
            "bucket_n_subs": sp.n_subs,
            "bucket_txt_len": sp.txt_len,
            "bucket_frames_per_sub": sp.frames_per_sub,
            # max_clip_len clamps (videos are cut to it): the user's value
            # wins where the corpus quantile exceeds it
            "max_clip_len": min(a.max_clip_len, sp.n_frames),
        })
    return flags


def main(argv=None) -> None:
    a = build_argparser().parse_args(argv)
    flags = suggest(a)
    print(json.dumps(dict(flags, pack_subs=bool(a.pack), task=a.task,
                          coverage=a.coverage)))
    cli = " ".join(f"--{k} {v}" for k, v in flags.items())
    if a.pack:
        cli += " --pack_subs"
    print(f"# {cli}", file=sys.stderr)


if __name__ == "__main__":
    main()
