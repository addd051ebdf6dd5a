"""VR-only inference as a program (counterpart of
``hero_tpu/drivers/eval_vr.py``, on one card or several ranks):

    python -m hero_tpu_torch.drivers.eval_vr --output_dir <train dir> \
        --checkpoint <step or path> [--query_txt_db <db>] [--split val]

``drivers/eval_vcmr`` restricted to the VR task, with the MSR-VTT query
keys (reference eval_vr.py:69): the submission has ``video2idx`` and
``VR``.
"""

from __future__ import annotations

import torch

from hero_tpu_torch.data.store import MsrvttQueryTokStore
from hero_tpu_torch.drivers import eval_vcmr
from hero_tpu_torch.utils.logger import configure_stdout


def main(args, *, device="cuda", dtype: torch.dtype = torch.bfloat16):
    """:func:`eval_vcmr.main` with ``MsrvttQueryTokStore`` and
    ``full_eval_tasks=("VR",)`` (``hero_tpu/drivers/eval_vr.py:10-16``).
    Returns (metrics, submission)."""
    return eval_vcmr.main(args, query_store_cls=MsrvttQueryTokStore,
                          full_eval_tasks=("VR",), device=device,
                          dtype=dtype)


def cli():
    """The console script's entry (``hero-tpu-torch-eval-vr``)."""
    configure_stdout()
    main(eval_vcmr.build_argparser().parse_args())


if __name__ == "__main__":
    cli()
