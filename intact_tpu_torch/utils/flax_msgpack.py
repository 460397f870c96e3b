"""The msgpack subset that `flax.serialization` writes, in the standard
library and numpy alone (no `msgpack`, no flax).

flax's `msgpack_serialize` writes a nested map of str keys whose leaves are
ints, floats, strs, bools, nil, bins, arrays (lists), and numpy arrays as
msgpack ext type 1: a nested msgpack array (shape, dtype name, C-order
bytes). numpy scalars are ext type 3 in the same form. Arrays above 2**30
bytes are split into a map {"__msgpack_chunked_array__": True, "shape": {"0":
...}, "chunks": {"0": flat chunk, ...}}, which `unpackb` joins back.

`unpackb` decodes that subset (arrays are read-only views of the input
bytes; bfloat16 arrays come back as float32, exactly); `packb` writes it
(arrays as one ext each, never chunked), so a tree it writes reads back
with `flax.serialization.msgpack_restore` too.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), self.take(n))
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return str(self.take(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])), "utf-8")
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} at offset {self.pos - 1} is not in the flax subset")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    @staticmethod
    def ext(code: int, data: memoryview):
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not one flax writes for arrays")
        shape, dtype_name, raw = _Reader(data).value()
        arr = _array(bytes(dtype_name) if isinstance(dtype_name, memoryview) else dtype_name, raw, tuple(shape))
        return arr[()] if code == EXT_NPSCALAR else arr


def _array(dtype_name, raw: memoryview, shape: tuple) -> np.ndarray:
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":  # numpy has no bfloat16: the top half of a float32, exactly
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(node):
    if not isinstance(node, dict):
        return node
    if node.get(_CHUNKED) is True:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def unpackb(data) -> object:
    """flax msgpack bytes -> the tree (dicts, lists, numbers, strs, numpy
    arrays; bins as bytes)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes after the msgpack value")

    def bins(node):
        if isinstance(node, memoryview):
            return bytes(node)
        if isinstance(node, dict):
            return {k: bins(v) for k, v in node.items()}
        if isinstance(node, list):
            return [bins(v) for v in node]
        return node

    return _unchunk(bins(out))


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _int(x: int) -> bytes:
    if 0 <= x <= 0x7F:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack(">b", x)
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"), (0, 0xFFFFFFFF, 0xCE, ">I"),
                              (0, 2**64 - 1, 0xCF, ">Q"), (-2**7, 2**7 - 1, 0xD0, ">b"),
                              (-2**15, 2**15 - 1, 0xD1, ">h"), (-2**31, 2**31 - 1, 0xD2, ">i"),
                              (-2**63, 2**63 - 1, 0xD3, ">q")):
        if lo <= x <= hi:
            return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError(f"{x} does not fit a msgpack int")


def _sized(n: int, fix_base: int | None, fix_max: int, codes: tuple, what: str) -> bytes:
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{what} of {n} entries or bytes is too long for msgpack")


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n]]) + struct.pack(">b", code) + payload
    return _sized(n, None, 0, (0xC7, 0xC8, 0xC9), "ext") + struct.pack(">b", code) + payload


def _pack(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, (np.ndarray, np.generic)):
        arr = np.asarray(x)
        if arr.dtype.hasobject:
            raise ValueError("object arrays have no flax msgpack form")
        inner: list = []
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], inner)
        out.append(_ext(EXT_NDARRAY if isinstance(x, np.ndarray) else EXT_NPSCALAR, b"".join(inner)))
    elif isinstance(x, int):
        out.append(_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        out.append(_sized(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), "str") + raw)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        raw = bytes(x)
        out.append(_sized(len(raw), None, 0, (0xC4, 0xC5, 0xC6), "bin") + raw)
    elif isinstance(x, (list, tuple)):
        out.append(_sized(len(x), 0x90, 15, (None, 0xDC, 0xDD), "array"))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        out.append(_sized(len(x), 0x80, 15, (None, 0xDE, 0xDF), "map"))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"{type(x).__name__} has no flax msgpack form")


def packb(tree) -> bytes:
    """A tree of dicts, lists, numbers, strs, bytes and numpy arrays -> msgpack
    bytes in flax's form."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)
