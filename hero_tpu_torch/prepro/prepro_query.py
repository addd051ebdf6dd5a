"""TVR/DiDeMo/MSR-VTT/TVQA/How2QA/VIOLIN query jsonl to a query store (the
port's ``scripts/prepro_query.py``; reference ``scripts/prepro_query.py``).

    python -m hero_tpu_torch.prepro.prepro_query --query_jsonl Q \\
        --output DB [--task tvr] [--tokenizer hash]

``--task tvqa``/``how2qa`` writes :func:`build_dbs.build_qa_query_db`'s
store, every other task :func:`build_dbs.build_query_db`'s."""

from __future__ import annotations

import argparse

from hero_tpu_torch.prepro.build_dbs import build_qa_query_db, build_query_db
from hero_tpu_torch.prepro.tokenize import get_tokenizer
from hero_tpu_torch.utils.basic_utils import load_jsonl

TASKS = ("tvr", "didemo", "msrvtt", "tvqa", "how2qa", "violin")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--query_jsonl", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--task", default="tvr", choices=TASKS)
    p.add_argument("--tokenizer", default="roberta",
                   choices=["roberta", "hash"])
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    items = load_jsonl(args.query_jsonl)
    tok = get_tokenizer(args.tokenizer)
    if args.task in ("tvqa", "how2qa"):
        build_qa_query_db(args.output, items, tok)
    else:
        build_query_db(args.output, items, tok)
    print(f"wrote {len(items)} queries to {args.output}")


if __name__ == "__main__":
    main()
