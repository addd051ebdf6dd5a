"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled for ``sm_90a`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), named by a hash of its sources and flags so an edited source is
rebuilt and a stale library is never loaded.  Libraries land in
``ops/build/`` (git-ignored) at first use; :func:`build` starts one nvcc per
missing library, all at once, and waits for all of them.

Nothing here runs at import time: the CPU tests import every module on a
machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("attention", "layernorm")
# --split-compile 0: nvcc optimizes a source's kernels on every core (the
# attention source's ~50 kernels build in about half the time)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives, keyed by a hash of
    the sources (the .cu and every shared header) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all running together.  Raises with nvcc's output
    if any build fails.  Returns {name: library path}; the compiler's
    report (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside each library as ``<library>.log``."""
    names = tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for name in names:
            so = library_path(name)
            if so.exists():
                continue
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            log = so.with_name(so.name + ".log")
            with open(log, "w") as f:
                p = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=f, stderr=subprocess.STDOUT)
            procs.append((name, p, tmp, so, log))
        errors = []
        for name, p, tmp, so, log in procs:
            if p.wait() != 0:
                errors.append(f"nvcc failed for {name}.cu "
                              f"(exit {p.returncode}):\n{log.read_text()}")
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, p, tmp, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            if tmp.exists():
                tmp.unlink()
    return {name: library_path(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build((name,))[name]))
            lib.hero_error_string.argtypes = [ctypes.c_int]
            lib.hero_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.hero_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
