"""A pure-Python msgpack reader and writer, with flax's array extension.

The JAX package keeps its clip-store index (`meta.msgpack`) and its
checkpoints (`flax.serialization.msgpack_serialize`) in msgpack. The
port reads both without the `msgpack` or `flax` packages:

- `unpackb` decodes every msgpack type: nil, bool, all int and float
  widths, str, bin, array, map and ext. Strings come back as `str`, bin
  as `bytes`, arrays as lists, maps as dicts with keys of any type.
- flax's ext type 1 (an ndarray: a msgpack `(shape, dtype name,
  C-order bytes)`) comes back as a read-only numpy array, ext type 3 (a
  numpy scalar) as a numpy scalar. Any other ext type, bfloat16 arrays
  and flax's chunked-array marker raise `ValueError` with the reason.
- `packb` writes what `msgpack.packb(obj, use_bin_type=True)` writes
  (doubles for floats, the smallest int encoding), and numpy arrays and
  scalars as flax writes them, so its output is byte-identical to flax's
  for the same tree and `flax.serialization.msgpack_restore` reads it.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# -- reading ---------------------------------------------------------------
def _array_from_ext(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported: numpy has no "
                         "bfloat16 type (save the checkpoint in float32)")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _array_from_ext(data)
    if code == EXT_NPSCALAR:
        return _array_from_ext(data)[()]
    raise ValueError(f"msgpack ext type {code} is not supported (only "
                     f"flax's ndarray {EXT_NDARRAY} and numpy scalar "
                     f"{EXT_NPSCALAR})")


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
        0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",
        0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _read(buf: memoryview, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if 0x90 <= b <= 0x9f:
        return _read_array(buf, pos, b & 0x0f)
    if 0x80 <= b <= 0x8f:
        return _read_map(buf, pos, b & 0x0f)
    if b == 0xc0:
        return None, pos
    if b == 0xc2:
        return False, pos
    if b == 0xc3:
        return True, pos
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if b in _FIXEXT:
        n = _FIXEXT[b]
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    if b in _LEN:
        fmt = _LEN[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(buf[pos:pos + n]), pos + n
        if b in (0xd9, 0xda, 0xdb):
            return str(buf[pos:pos + n], "utf-8"), pos + n
        if b in (0xdc, 0xdd):
            return _read_array(buf, pos, n)
        if b in (0xde, 0xdf):
            return _read_map(buf, pos, n)
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    raise ValueError(f"byte 0x{b:02x} at offset {pos - 1} is not a msgpack "
                     f"type")


def _read_array(buf: memoryview, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, pos = _read(buf, pos)
        out.append(v)
    return out, pos


def _read_map(buf: memoryview, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _read(buf, pos)
        v, pos = _read(buf, pos)
        out[k] = v
    if _CHUNKED in out:
        raise ValueError("flax chunked arrays (leaves over 1 GiB) are not "
                         "supported")
    return out, pos


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object; trailing bytes raise ValueError."""
    buf = memoryview(data)
    obj, pos = _read(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} bytes after the msgpack object")
    return obj


# -- writing ---------------------------------------------------------------
def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack(">B", n)
    if -0x20 <= n < 0:
        return struct.pack(">b", n)
    if 0 <= n <= 0xff:
        return b"\xcc" + struct.pack(">B", n)
    if -0x80 <= n < 0:
        return b"\xd0" + struct.pack(">b", n)
    if 0 <= n <= 0xffff:
        return b"\xcd" + struct.pack(">H", n)
    if -0x8000 <= n < 0:
        return b"\xd1" + struct.pack(">h", n)
    if 0 <= n <= 0xffffffff:
        return b"\xce" + struct.pack(">I", n)
    if -0x80000000 <= n < 0:
        return b"\xd2" + struct.pack(">i", n)
    if 0 <= n <= 0xffffffffffffffff:
        return b"\xcf" + struct.pack(">Q", n)
    if -0x8000000000000000 <= n < 0:
        return b"\xd3" + struct.pack(">q", n)
    raise OverflowError(f"integer {n} does not fit 64 bits")


def _sized(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
           fmts: Tuple[str, ...]) -> bytes:
    """Header of a str / bin / array / map of n items or bytes."""
    if fix >= 0 and n <= fix_max:
        return bytes([fix | n])
    for code, fmt in zip(codes, fmts):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"object of size {n} is too large for msgpack")


def _ext_bytes(code: int, data: bytes) -> bytes:
    n = len(data)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        head = bytes([fixext[n]])
    else:
        head = _sized(n, -1, -1, (0xc7, 0xc8, 0xc9), (">B", ">H", ">I"))
    return head + struct.pack(">b", code) + data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured arrays cannot be packed")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _write(obj: Any, out: list) -> None:
    if isinstance(obj, np.ndarray):
        out.append(_ext_bytes(EXT_NDARRAY, _ndarray_bytes(obj)))
    elif isinstance(obj, np.generic):
        out.append(_ext_bytes(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj))))
    elif obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_sized(len(raw), 0xa0, 31, (0xd9, 0xda, 0xdb),
                          (">B", ">H", ">I")) + raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(_sized(len(raw), -1, -1, (0xc4, 0xc5, 0xc6),
                          (">B", ">H", ">I")) + raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_sized(len(obj), 0x90, 15, (0xdc, 0xdd), (">H", ">I")))
        for v in obj:
            _write(v, out)
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), 0x80, 15, (0xde, 0xdf), (">H", ">I")))
        for k, v in obj.items():
            _write(k, out)
            _write(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode obj (None, bool, int, float, str, bytes, list / tuple,
    dict, numpy arrays and scalars)."""
    out: list = []
    _write(obj, out)
    return b"".join(out)
