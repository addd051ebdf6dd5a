"""The msgpack subset that herostore writes and reads, without the
``msgpack`` package.

``packb(v)`` gives the bytes of ``msgpack.packb(v, use_bin_type=True,
default=_pack_default)`` as ``hero_tpu/data/store.py:35-80`` calls it, and
``unpackb`` inverts it as ``msgpack.unpackb(b, raw=False,
ext_hook=_unpack_ext)`` does.  The subset:

- nil, bool, int (every width up to 64 bits), float (always float64, as
  ``msgpack`` writes a Python float), str (UTF-8, str8/16/32 framing),
  bin (bytes, bytearray, memoryview), array (list or tuple; read back as a
  list) and map (dict, in insertion order; keys read back must be str or
  bytes, as msgpack's ``strict_map_key`` requires);
- ``np.integer`` packs as int and ``np.floating`` as float;
- an ``np.ndarray`` packs as ext type 42: a little-endian uint32 header
  length, the msgpack header ``(dtype.str, shape)`` and the C-order bytes
  (fixext 1/2/4/8/16 or ext 8/16/32 framing); it unpacks as a read-only
  array over the payload.

Anything else raises ``TypeError``: other types on packing, other formats
(float32, other ext types, timestamps) on unpacking.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

ND_EXT = 42  # the ext type of an ndarray


def pack_ndarray(arr: np.ndarray) -> bytes:
    """An ndarray's payload (the ``raw`` codec's record, the ext-42
    data): uint32 header length, msgpack ``(dtype.str, shape)``, the
    C-order bytes."""
    header = packb((arr.dtype.str, arr.shape))
    return (struct.pack("<I", len(header)) + header
            + np.ascontiguousarray(arr).tobytes())


def unpack_ndarray(data) -> np.ndarray:
    """Inverse of :func:`pack_ndarray`: an array over ``data``'s bytes."""
    (hlen,) = struct.unpack_from("<I", data, 0)
    dtype_str, shape = unpackb(bytes(data[4:4 + hlen]))
    arr = np.frombuffer(data, dtype=np.dtype(dtype_str), offset=4 + hlen)
    return arr.reshape(shape)


def _pack_len(out: bytearray, n: int, fix_base, fix_max, codes) -> None:
    """A length prefix: the fix form up to ``fix_max`` (when there is
    one), else the narrowest of ``codes`` (8-, 16-, 32-bit lengths)."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v > 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise TypeError(f"cannot serialize {type(v)}: {v} exceeds 64 bits")
    else:
        for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                 (0xD2, ">i", -0x80000000),
                                 (0xD3, ">q", -0x8000000000000000)):
            if v >= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise TypeError(f"cannot serialize {type(v)}: {v} exceeds 64 bits")


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack(out: bytearray, v: Any, depth: int) -> None:
    if depth > 512:
        raise ValueError("msgpack nesting too deep")
    # the order of msgpack's packer: an np.float64 is a float, an
    # np.int64 (not an int subclass) goes through the default conversion
    if v is None:
        out.append(0xC0)
    elif v is True:
        out.append(0xC3)
    elif v is False:
        out.append(0xC2)
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, (bytes, bytearray)):
        _pack_len(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 15, (None, 0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k, depth + 1)
            _pack(out, x, depth + 1)
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), 0x90, 15, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x, depth + 1)
    elif isinstance(v, memoryview):
        b = v.tobytes()
        _pack_len(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(v, np.ndarray):
        data = pack_ndarray(v)
        if len(data) in _FIXEXT:
            out.append(_FIXEXT[len(data)])
        else:
            _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
        out.append(ND_EXT)
        out += data
    elif isinstance(v, np.integer):
        _pack_int(out, int(v))
    elif isinstance(v, np.floating):
        out.append(0xCB)
        out += struct.pack(">d", float(v))
    else:
        raise TypeError(f"cannot serialize {type(v)}")


def packb(value: Any) -> bytes:
    """``msgpack.packb(value, use_bin_type=True, default=_pack_default)``."""
    out = bytearray()
    _pack(out, value, 0)
    return bytes(out)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        (v,) = struct.unpack(fmt, self.take(size))
        return v


# fixed-width formats: code -> struct format
_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN8_16_32 = {0: ">B", 1: ">H", 2: ">I"}


def _unpack(r: _Reader, depth: int) -> Any:
    if depth > 512:
        raise ValueError("msgpack nesting too deep")
    c = r.take(1)[0]
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0x80 <= c <= 0x8F:
        return _unpack_map(r, c & 0x0F, depth)
    if 0x90 <= c <= 0x9F:
        return [_unpack(r, depth + 1) for _ in range(c & 0x0F)]
    if 0xA0 <= c <= 0xBF:
        return r.take(c & 0x1F).decode("utf-8")
    if c == 0xC0:
        return None
    if c == 0xC2:
        return False
    if c == 0xC3:
        return True
    if c in _INTS:
        return r.unpack(_INTS[c])
    if c == 0xCB:
        return r.unpack(">d")
    if 0xC4 <= c <= 0xC6:
        return r.take(r.unpack(_LEN8_16_32[c - 0xC4]))
    if 0xD9 <= c <= 0xDB:
        return r.take(r.unpack(_LEN8_16_32[c - 0xD9])).decode("utf-8")
    if c in (0xDC, 0xDD):
        n = r.unpack(">H" if c == 0xDC else ">I")
        return [_unpack(r, depth + 1) for _ in range(n)]
    if c in (0xDE, 0xDF):
        return _unpack_map(r, r.unpack(">H" if c == 0xDE else ">I"), depth)
    if 0xD4 <= c <= 0xD8:
        return _unpack_ext(r, 1 << (c - 0xD4))
    if 0xC7 <= c <= 0xC9:
        return _unpack_ext(r, r.unpack(_LEN8_16_32[c - 0xC7]))
    raise TypeError(f"msgpack format 0x{c:02x} is outside herostore's "
                    "subset")


def _unpack_map(r: _Reader, n: int, depth: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r, depth + 1)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map "
                             "key")
        out[k] = _unpack(r, depth + 1)
    return out


def _unpack_ext(r: _Reader, n: int) -> np.ndarray:
    code = struct.unpack(">b", r.take(1))[0]
    if code != ND_EXT:
        raise TypeError(f"msgpack ext type {code} is outside herostore's "
                        "subset")
    return unpack_ndarray(r.take(n))


def unpackb(buf: bytes) -> Any:
    """``msgpack.unpackb(buf, raw=False, ext_hook=_unpack_ext)``."""
    r = _Reader(bytes(buf))
    out = _unpack(r, 0)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after "
                         "the msgpack value")
    return out

