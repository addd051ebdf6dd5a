"""TVC caption jsonl to ``cap.db`` and ``clip.db`` (the port's
``scripts/prepro_tvc.py``; reference ``scripts/prepro_tvc.py``).

    python -m hero_tpu_torch.prepro.prepro_tvc --caption_jsonl C \\
        --output ROOT [--tokenizer hash]

Rows: ``{"vid_name", "ts": [st, ed], "clip_id", "duration",
"descs": [{"desc_id", "desc"}]}``; writes
:func:`build_dbs.build_caption_db`'s stores under ``ROOT``."""

from __future__ import annotations

import argparse

from hero_tpu_torch.prepro.build_dbs import build_caption_db
from hero_tpu_torch.prepro.tokenize import get_tokenizer
from hero_tpu_torch.utils.basic_utils import load_jsonl


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--caption_jsonl", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--tokenizer", default="roberta",
                   choices=["roberta", "hash"])
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    items = load_jsonl(args.caption_jsonl)
    build_caption_db(args.output, items, get_tokenizer(args.tokenizer))
    print(f"wrote captions for {len(items)} clips to {args.output}")


if __name__ == "__main__":
    main()
