"""msgpack with ndarray extension — the INT-ACT wire format.

Wire contract (must stay byte-compatible with the reference
`policy_server_client/msgpack_numpy.py:21-57` so its clients interoperate):

  np.ndarray  <->  {b"__ndarray__": True, b"data": <raw bytes, C order>,
                    b"dtype": <numpy dtype str, e.g. "<f4">, b"shape": (...)}
  np.generic  <->  {b"__npgeneric__": True, b"data": <python scalar>,
                    b"dtype": <numpy dtype str>}

Object / void / complex dtypes are rejected (they would need pickle, which is
unsafe over a network socket).
"""

from __future__ import annotations

import functools

import msgpack
import numpy as np

_REJECTED_KINDS = ("V", "O", "c")  # void / object / complex


def pack_array(obj):
    """msgpack `default=` hook: encode ndarrays/scalars as tagged maps."""
    if isinstance(obj, (np.ndarray, np.generic)) and obj.dtype.kind in _REJECTED_KINDS:
        raise ValueError(f"Unsupported dtype: {obj.dtype}")

    if isinstance(obj, np.ndarray):
        return {
            b"__ndarray__": True,
            b"data": obj.tobytes(),
            b"dtype": obj.dtype.str,
            b"shape": obj.shape,
        }

    if isinstance(obj, np.generic):
        return {
            b"__npgeneric__": True,
            b"data": obj.item(),
            b"dtype": obj.dtype.str,
        }

    return obj


def unpack_array(obj):
    """msgpack `object_hook`: decode tagged maps back to numpy values."""
    if b"__ndarray__" in obj:
        # Zero-copy view over the received buffer; callers treat results as
        # read-only snapshots of one request.
        return np.ndarray(
            buffer=obj[b"data"], dtype=np.dtype(obj[b"dtype"]), shape=obj[b"shape"]
        )

    if b"__npgeneric__" in obj:
        return np.dtype(obj[b"dtype"]).type(obj[b"data"])

    return obj


Packer = functools.partial(msgpack.Packer, default=pack_array)
packb = functools.partial(msgpack.packb, default=pack_array)

Unpacker = functools.partial(msgpack.Unpacker, object_hook=unpack_array)
unpackb = functools.partial(msgpack.unpackb, object_hook=unpack_array)
