"""hero_tpu_torch — HERO in PyTorch + CUDA: the two-phase VCMR serving path
(packed queries, the chunked corpus, and as programs from stores and a
checkpoint: ``python -m hero_tpu_torch.drivers.eval_vcmr``, and
``drivers.eval_vr`` for video retrieval alone), the four-task
pretraining recipe (MLM, MFM-NCE / MFFR, FOM and VSM, from herostore
databases on disk through the MetaLoader, with checkpoints and resume in
the JAX package's file layout: ``python -m hero_tpu_torch.drivers.pretrain
--config <json>``), VCMR and VR finetuning as programs (``python -m
hero_tpu_torch.drivers.train_vcmr --config <json>`` for TVR, How2R and
DiDeMo, ``drivers.train_vr`` for MSR-VTT, with subtitles or video-only),
VideoQA and VIOLIN finetuning and inference as programs (``python -m
hero_tpu_torch.drivers.train_videoqa --config <json>`` for TVQA and
How2QA, ``drivers.train_violin``, ``drivers.eval_videoqa`` and
``drivers.eval_violin``), and TVC finetuning and captioning as programs (``python -m
hero_tpu_torch.drivers.train_tvc --config <json>``, ``python -m
hero_tpu_torch.drivers.inf_tvc --output_dir D --checkpoint N``, scored by
``evaluation.caption_metrics``).  Every program starts from a JAX-layout
``.npz`` or the reference's ``.pt`` (``convert.torch_checkpoint``; e.g.
the released ``hero-tv-ht100.pt``), and runs as one process or as ranks
of ``torch.distributed`` (``parallel``: data parallelism, ``--zero1``,
``--pp_stages``; tensor and sequence parallelism as library functions).

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
