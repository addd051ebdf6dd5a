"""Logging and scalar metrics (counterpart of ``hero_tpu/utils/logger.py``):
the package's ``LOGGER``, a log file beside the run, a metric writer
(JSONL always, TensorBoard when ``torch.utils.tensorboard`` imports), its
no-op stand-in, and the EMA ``RunningMeter``.

Importing configures nothing; :func:`configure_stdout` (the command line)
and :func:`add_log_to_file` (a run's ``log/log.txt``) attach handlers.
Every module of the port logs under ``hero_tpu_torch.*``, so both reach
them all.
"""

from __future__ import annotations

import json
import logging
import math
import os
import sys
from typing import Optional

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"
LOGGER = logging.getLogger("hero_tpu_torch")


def configure_stdout() -> None:
    """INFO and above to stdout, in the JAX package's format."""
    logging.basicConfig(format=_LOG_FMT, datefmt=_DATE_FMT,
                        level=logging.INFO, stream=sys.stdout)


def add_log_to_file(log_path: str) -> logging.Handler:
    """Copy the package's INFO and above to ``log_path``; returns the
    handler (``LOGGER.removeHandler`` and ``close`` end it)."""
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    fh = logging.FileHandler(log_path)
    fh.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
    LOGGER.addHandler(fh)
    if LOGGER.getEffectiveLevel() > logging.INFO:
        LOGGER.setLevel(logging.INFO)
    return fh


class NoOp:
    """A metric writer that writes nothing (a run without an output
    directory)."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class ScalarWriter:
    """Scalar metric writer: ``scalars.jsonl`` always, TensorBoard too if
    importable.  A scalar without a step takes the one :meth:`set_step`
    set last (0 at first)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:       # tensorboard not installed
            SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(log_dir)
        self._global_step = 0

    def set_step(self, step: int) -> None:
        self._global_step = step

    def add_scalar(self, tag: str, value: float,
                   step: Optional[int] = None) -> None:
        step = self._global_step if step is None else step
        value = float(value)
        self._jsonl.write(json.dumps({"step": step, tag: value}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def log_scalar_dict(self, d: dict, step: Optional[int] = None) -> None:
        for k, v in d.items():
            if isinstance(v, (int, float)):
                self.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class RunningMeter:
    """Exponential moving average (smooth 0.99, reference
    ``utils/logger.py`` RunningMeter); NaN and inf are skipped."""

    SMOOTH = 0.99

    def __init__(self, name: str):
        self._name = name
        self._val: Optional[float] = None

    def __call__(self, value: float) -> None:
        value = float(value)
        if math.isnan(value) or math.isinf(value):
            return
        self._val = (value if self._val is None
                     else self._val * self.SMOOTH
                     + value * (1 - self.SMOOTH))

    @property
    def val(self) -> float:
        return 0.0 if self._val is None else self._val

    @property
    def name(self) -> str:
        return self._name
