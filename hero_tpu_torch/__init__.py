"""hero_tpu_torch — HERO in PyTorch + CUDA: the two-phase VCMR serving path,
the four-task pretraining recipe (MLM, MFM-NCE / MFFR, FOM and VSM, from
herostore databases on disk through the MetaLoader, with checkpoints and
resume in the JAX package's file layout: ``python -m
hero_tpu_torch.drivers.pretrain --config <json>``), TVC caption serving
and the TVC train step.

A port of ``hero_tpu`` (the JAX/Pallas package beside it, which stays the
reference) to one NVIDIA H100.  Module names mirror ``hero_tpu`` so each
port module has an obvious counterpart; the package imports ``torch`` and
never ``jax`` or ``hero_tpu``.

Every Pallas kernel of the JAX package has a hand-written CUDA kernel for
``sm_90a`` under ``ops/csrc`` (built with nvcc at first use, bound with
ctypes), behind a ``torch.autograd.Function`` whose backward is a kernel
too.  Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; with no card they raise instead of falling back.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for but absent
    (the port never silently carries on on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain PyTorch "
            "path")
    return dev
