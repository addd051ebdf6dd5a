"""Subtitles jsonl to the sub store (the port's ``scripts/prepro_sub.py``;
reference ``scripts/prepro_sub.py``).

    python -m hero_tpu_torch.prepro.prepro_sub --sub_jsonl S \\
        --vid2nframe N.json --output DB [--tokenizer hash]

Rows of the jsonl: ``{"vid_name": str, "sub": [{"text", "start",
"end"}]}``; ``--vid2nframe``: {vid: frames} (the video store's
``id2nframe.json``).  Writes :func:`build_dbs.build_sub_db`'s store."""

from __future__ import annotations

import argparse

from hero_tpu_torch.prepro.build_dbs import build_sub_db
from hero_tpu_torch.prepro.tokenize import get_tokenizer
from hero_tpu_torch.utils.basic_utils import load_json, load_jsonl


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sub_jsonl", required=True)
    p.add_argument("--vid2nframe", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--frame_length", default=1.5, type=float)
    p.add_argument("--split", default="train")
    p.add_argument("--tokenizer", default="roberta",
                   choices=["roberta", "hash"])
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    vid2subs = {d["vid_name"]: d["sub"] for d in load_jsonl(args.sub_jsonl)}
    build_sub_db(args.output, vid2subs, load_json(args.vid2nframe),
                 args.frame_length, get_tokenizer(args.tokenizer),
                 split=args.split)


if __name__ == "__main__":
    main()
