"""Native (C++) host ops over ctypes (intact_tpu/native with the port's build).

`fastops.cpp` is a copy of the JAX package's; `ops/build.py` compiles it with
the same g++ flags (-O3 -march=native) into `intact_tpu_torch/_build/` at first
use, so on one machine its output is bit-equal to `intact_tpu.native`'s (the
normalize is then a fused multiply-add, one float32 ulp from numpy's). A failed
build raises: the numpy versions below (`*_reference`) are the tests' reference,
not a fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np

from intact_tpu_torch.ops import build

_lib = None


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("fastops")
        lib.resize_bilinear_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.resize_bilinear_u8.restype = None
        lib.u8_to_normalized_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
        ]
        lib.u8_to_normalized_f32.restype = None
        lib.assemble_batch_f32.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.assemble_batch_f32.restype = None
        lib.fastops_abi_version.argtypes = []
        lib.fastops_abi_version.restype = ctypes.c_int
        if lib.fastops_abi_version() != 1:
            raise RuntimeError("native/fastops.cpp: unexpected ABI version")
        _lib = lib
    return _lib


def _frame(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3:
        raise ValueError(f"expected a [H, W, C] uint8 frame, got shape {img.shape}")
    return img


def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [dh, dw, C] (cv2 INTER_LINEAR's pixel centres)."""
    img = _frame(img)
    h, w, c = img.shape
    out = np.empty((dh, dw, c), np.uint8)
    library().resize_bilinear_u8(img.ctypes.data, h, w, c, out.ctypes.data, dh, dw)
    return out


def normalize_u8(img: np.ndarray, scale: float = 2.0 / 255.0, offset: float = -1.0) -> np.ndarray:
    """uint8 [...] -> float32 x * scale + offset, one pass."""
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty(img.shape, np.float32)
    library().u8_to_normalized_f32(img.ctypes.data, out.ctypes.data, img.size, ctypes.c_float(scale),
                                   ctypes.c_float(offset))
    return out


def assemble_batch(frames: list[np.ndarray], dh: int, dw: int, scale: float = 2.0 / 255.0,
                   offset: float = -1.0) -> np.ndarray:
    """N uint8 [h_i, w_i, C] frames -> normalized float32 [N, dh, dw, C], each
    frame resized where its size differs."""
    frames = [_frame(f) for f in frames]
    c = frames[0].shape[-1]
    if any(f.shape[-1] != c for f in frames):
        raise ValueError("frames differ in channel count")
    n = len(frames)
    ptrs = (ctypes.c_void_p * n)(*[f.ctypes.data for f in frames])
    shs = np.asarray([f.shape[0] for f in frames], np.int32)
    sws = np.asarray([f.shape[1] for f in frames], np.int32)
    scratch = np.empty((dh, dw, c), np.uint8)
    out = np.empty((n, dh, dw, c), np.float32)
    library().assemble_batch_f32(ptrs, shs.ctypes.data, sws.ctypes.data, n, c, dh, dw, ctypes.c_float(scale),
                                 ctypes.c_float(offset), scratch.ctypes.data, out.ctypes.data)
    return out


def normalize_u8_reference(img: np.ndarray, scale: float = 2.0 / 255.0, offset: float = -1.0) -> np.ndarray:
    """numpy's x * scale + offset in float32 (two roundings, no FMA)."""
    return np.asarray(img, np.uint8).astype(np.float32) * np.float32(scale) + np.float32(offset)


def resize_bilinear_reference(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """fastops.cpp's resize in numpy float32 (the same pixel centres and +0.5 rounding)."""
    img = np.asarray(img, np.uint8)
    sh, sw, _ = img.shape

    def axis(d, s):
        f = (np.arange(d, dtype=np.float32) + np.float32(0.5)) * np.float32(s / d) - np.float32(0.5)
        i0 = np.where(f < 0, 0, f.astype(np.int32))
        f = np.maximum(f, np.float32(0))
        return i0, np.minimum(i0 + 1, s - 1), (f - i0).astype(np.float32)

    y0, y1, wy = axis(dh, sh)
    x0, x1, wx = axis(dw, sw)
    src = img.astype(np.float32)
    one = np.float32(1)
    top = src[y0][:, x0] * (one - wx)[None, :, None] + src[y0][:, x1] * wx[None, :, None]
    bot = src[y1][:, x0] * (one - wx)[None, :, None] + src[y1][:, x1] * wx[None, :, None]
    v = top * (one - wy)[:, None, None] + bot * wy[:, None, None]
    return (v + np.float32(0.5)).astype(np.uint8)
