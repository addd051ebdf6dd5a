"""Misc helpers (a copy of the torch-free part of
``hero_tpu/utils/misc.py``)."""

from __future__ import annotations

import random
from typing import Any

import numpy as np
import torch


class Struct:
    """dict -> attribute access (reloads a train-time hps.json as a
    serve-time config, reference ``eval_vcmr.py:56-58``)."""

    def __init__(self, d: dict):
        self.__dict__.update(d)

    def __contains__(self, k) -> bool:
        return k in self.__dict__

    def get(self, k, default=None) -> Any:
        return self.__dict__.get(k, default)

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def set_random_seed(seed: int) -> None:
    """Seed the host's RNGs (python, numpy) and torch's default
    generators.  The model's dropout draws from Philox streams keyed by
    the step's seed (``models/nn.rng_for``), not from these."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
