"""ctypes wrapper for libherostore (``herostore.cpp``, a copy of
``hero_tpu/native/herostore.cpp``): mmap'd record reads, batched gather
reads and LZ4 block compression.

The shared library is built with g++ at first use, with portable flags
(``-O3 -mtune=generic``, never ``-march=native``), into ``build/`` beside
this file, named by the source's hash and the machine's architecture.  A
provenance sidecar (source hash, architecture, compiler, flags) is checked
before every load; a mismatch rebuilds.  Without g++ the library is
unavailable and the stores read through Python's mmap (the same bytes).
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import json
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "herostore.cpp")
_BUILD_DIR = os.path.join(_DIR, "build")
_CFLAGS = ["-O3", "-mtune=generic", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compiler_id() -> str:
    try:
        out = subprocess.run(["g++", "-dumpfullversion"],
                             capture_output=True, timeout=10)
        return "g++" + out.stdout.decode().strip()
    except (OSError, subprocess.SubprocessError):
        return "g++?"


def _provenance() -> dict:
    # this module defines its own ``open`` (the C API's name) below
    with io.open(_SRC, "rb") as f:
        src_sha = hashlib.sha256(f.read()).hexdigest()
    return {"src_sha": src_sha, "machine": platform.machine(),
            "compiler": _compiler_id(), "flags": " ".join(_CFLAGS)}


def _lib_path(prov: dict) -> str:
    return os.path.join(
        _BUILD_DIR,
        f"libherostore-{prov['src_sha'][:12]}-{prov['machine']}.so")


def _build(lib_path: str, prov: dict) -> bool:
    tmp = lib_path + f".tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        subprocess.run(["g++", *_CFLAGS, "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        with io.open(tmp + ".json", "w") as f:
            json.dump(prov, f)
        # concurrent builders race to identical files; the last rename wins
        os.replace(tmp + ".json", lib_path + ".json")
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _provenance_ok(lib_path: str, prov: dict) -> bool:
    try:
        with io.open(lib_path + ".json") as f:
            return json.load(f) == prov
    except (OSError, ValueError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        prov = _provenance()
        lib_path = _lib_path(prov)
        if not (os.path.exists(lib_path) and _provenance_ok(lib_path, prov)):
            if not _build(lib_path, prov):
                return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            return None
        lib.hs_open.restype = ctypes.c_void_p
        lib.hs_open.argtypes = [ctypes.c_char_p]
        lib.hs_close.restype = None
        lib.hs_close.argtypes = [ctypes.c_void_p]
        lib.hs_read.restype = ctypes.c_int64
        lib.hs_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.c_uint64, ctypes.c_void_p]
        lib.hs_read_many.restype = ctypes.c_int64
        lib.hs_read_many.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.hs_lz4_compress.restype = ctypes.c_int64
        lib.hs_lz4_compress.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_void_p, ctypes.c_int64]
        lib.hs_lz4_decompress.restype = ctypes.c_int64
        lib.hs_lz4_decompress.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
        return _lib


def _reset_for_tests() -> None:
    """Drop the loaded handle so the next call resolves the build again."""
    global _lib, _tried
    with _lock:
        _lib, _tried = None, False


def available() -> bool:
    return _load() is not None


def open(path: str):  # noqa: A001 - the C API's name
    lib = _load()
    h = lib.hs_open(path.encode())
    if not h:
        raise OSError(f"hs_open failed for {path}")
    return h


def close(handle) -> None:
    _load().hs_close(handle)


def read(handle, offset: int, length: int) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(length)
    n = lib.hs_read(handle, offset, length, out)
    if n != length:
        raise OSError("hs_read failed")
    return out.raw


def read_many(handle, offsets, lengths) -> tuple:
    """Gather records: (contiguous bytes, each record's start offset)."""
    lib = _load()
    offs = np.ascontiguousarray(offsets, dtype=np.uint64)
    lens = np.ascontiguousarray(lengths, dtype=np.uint64)
    if len(offs) != len(lens):
        raise ValueError("offsets and lengths differ in length")
    total = int(lens.sum())
    out = ctypes.create_string_buffer(total)
    out_offs = np.zeros(len(offs), dtype=np.uint64)
    n = lib.hs_read_many(
        handle, len(offs),
        offs.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p), out,
        out_offs.ctypes.data_as(ctypes.c_void_p))
    if n != total:
        raise OSError("hs_read_many failed")
    return out.raw, out_offs


def lz4_compress(data: bytes) -> bytes:
    lib = _load()
    cap = len(data) + len(data) // 255 + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.hs_lz4_compress(data, len(data), out, cap)
    if n < 0:
        raise ValueError("lz4 compress failed")
    return out.raw[:n]


def lz4_decompress(data: bytes, original_size: int) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(original_size)
    n = lib.hs_lz4_decompress(data, len(data), out, original_size)
    if n != original_size:
        raise ValueError(f"lz4 decompress failed ({n} != {original_size})")
    return out.raw
