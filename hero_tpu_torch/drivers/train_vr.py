"""MSR-VTT video-retrieval finetuning as a program (counterpart of
``hero_tpu/drivers/train_vr.py``, on one card or several ranks):

    python -m hero_tpu_torch.drivers.train_vr --config <json>

VCMR finetuning without span supervision (reference train_vr.py:78-114):
``lw_st_ed`` must be 0, ``drop_svmr_prob`` becomes 1, the items carry no
span targets (``VrDataset``) and the queries are keyed the MSR-VTT way
(``MsrvttQueryTokStore``).  ``config/train-msrvtt_video_{sub,only}.json``
are its configs.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from hero_tpu_torch.config import opts as opts_lib
from hero_tpu_torch.data.downstream_tasks import VrDataset
from hero_tpu_torch.data.store import MsrvttQueryTokStore
from hero_tpu_torch.drivers import train_vcmr
from hero_tpu_torch.training.step import TrainState
from hero_tpu_torch.utils.logger import configure_stdout


def main(opts, *, device="cuda", on_step: Optional[Callable] = None,
         dtype: torch.dtype = torch.bfloat16) -> TrainState:
    """Finetune VR as ``opts`` says (``hero_tpu/drivers/train_vr.py:
    12-22``): :func:`train_vcmr.main` with ``VrDataset`` and
    ``MsrvttQueryTokStore``.  Sets ``opts.lw_st_ed`` to 0.0 and
    ``opts.drop_svmr_prob`` to 1.0."""
    assert getattr(opts, "lw_st_ed", 0) == 0, "For VR, lw_st_ed must be 0"
    opts.lw_st_ed = 0.0
    opts.drop_svmr_prob = 1.0
    return train_vcmr.main(opts, dataset_cls=VrDataset,
                           query_store_cls=MsrvttQueryTokStore,
                           device=device, on_step=on_step, dtype=dtype)


def cli():
    """The console script's entry (``hero-tpu-torch-train-vr``)."""
    configure_stdout()
    main(opts_lib.get_vr_args())


if __name__ == "__main__":
    cli()
