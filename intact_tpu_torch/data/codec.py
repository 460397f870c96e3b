"""Image and record codec of the RLDS path, without TensorFlow, PIL or cv2.

Python over `csrc/host/codec.cpp` (built by g++ at first use into
`intact_tpu_torch/_build/`, bound with ctypes; a ctypes call releases the GIL,
so a thread pool decodes frames in parallel):

  decode_image       JPEG (libjpeg's IFAST IDCT, fancy upsampling and integer
                     YCbCr->RGB: what `tf.io.decode_image` gives with its
                     defaults) or PNG -> uint8 [H, W, 3]
  encode_jpeg        baseline JPEG as `tf.io.encode_jpeg(quality=q)` writes it
  encode_png         filter 0, zlib
  masked_crc32c      the TFRecord framing's checksum
  resize_lanczos3    `tf.image.resize(..., "lanczos3")`, with or without
                     antialias, clipped and truncated (or rounded) to uint8
  resize_lanczos4    cv2's INTER_LANCZOS4 on uint8 (the serving adapters')
  crop_resize_jitter the train path's crop, resize and colour jitter, given
                     its drawn values (`JitterDraws`)

`resize_lanczos3_reference` and `crop_resize_jitter_reference` are the same
arithmetic in numpy float32, the tests' reference for the C++ loops.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import NamedTuple

import numpy as np

from intact_tpu_torch.ops import build

_lib = None
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


class CodecError(ValueError):
    """An image or record the codec cannot read."""


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("codec")
        p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        sigs = {
            "codec_error": ([], ctypes.c_char_p),
            "codec_abi_version": ([], i32),
            "jpeg_header": ([p, i64, p, p, p], i32),
            "jpeg_decode": ([p, i64, p, i32, i32], i32),
            "jpeg_encode": ([p, i32, i32, i32, i32, p, i64], i64),
            "png_unfilter": ([p, i64, i32, i32, i32, p], i32),
            "crc32c": ([p, i64], ctypes.c_uint32),
            "resize_lanczos3_u8": ([p, i32, i32, i32, p, i32, i32, i32, i32], i32),
            "resize_lanczos4_cv_u8": ([p, i32, i32, i32, p, i32, i32], i32),
            "crop_resize_jitter_u8": ([p, i32, i32, p, i32, i32] + [f32] * 7, i32),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        if lib.codec_abi_version() != 1:
            raise RuntimeError("csrc/host/codec.cpp: unexpected ABI version")
        _lib = lib
    return _lib


def _check(rc: int) -> None:
    if rc < 0:
        raise CodecError(library().codec_error().decode())


def _buf(data) -> np.ndarray:
    """A zero-copy uint8 view of bytes-like `data` (kept alive by the caller)."""
    return np.frombuffer(data, np.uint8)


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

def jpeg_decode(data: bytes) -> np.ndarray:
    """Baseline JPEG -> RGB uint8 [H, W, 3] (gray replicated)."""
    lib, buf = library(), _buf(data)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib.jpeg_header(buf.ctypes.data, buf.size, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)))
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(lib.jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data, h.value, w.value))
    return out


def encode_jpeg(img: np.ndarray, quality: int = 95, subsample: bool = True) -> bytes:
    """RGB uint8 [H, W, 3] -> baseline JPEG (4:2:0 when `subsample`)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"encode_jpeg takes RGB [H, W, 3], got {img.shape}")
    lib = library()
    cap = img.size + 4096
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(img.ctypes.data, img.shape[0], img.shape[1], quality, int(subsample), out.ctypes.data, cap)
        if n == -1:
            _check(n)
        if n > 0:
            return out[:n].tobytes()
        cap = -n
    raise RuntimeError("jpeg_encode: output buffer sizing failed")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def png_decode(data: bytes) -> np.ndarray:
    """8-bit non-interlaced gray / gray+alpha / RGB / RGBA PNG -> RGB uint8
    [H, W, 3] (alpha dropped, gray replicated)."""
    data = bytes(data)
    if not data.startswith(_PNG_SIG):
        raise CodecError("not a PNG (bad signature)")
    pos, idat, head = 8, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise CodecError(f"truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise CodecError(f"PNG chunk {kind!r} fails its CRC")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if head is None:
        raise CodecError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = head
    if depth != 8:
        raise CodecError(f"{depth}-bit PNG is not supported: only 8-bit samples")
    if interlace:
        raise CodecError("interlaced (Adam7) PNG is not supported")
    if ctype not in _PNG_CHANNELS:
        raise CodecError(f"PNG colour type {ctype} (palette) is not supported")
    raw = zlib.decompress(b"".join(idat))
    out = np.empty((h, w, 3), np.uint8)
    buf = _buf(raw)
    _check(library().png_unfilter(buf.ctypes.data, buf.size, h, w, _PNG_CHANNELS[ctype], out.ctypes.data))
    return out


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C 1-4) -> PNG, every row filter 0."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return (_PNG_SIG + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes())) + _png_chunk(b"IEND", b""))


def decode_image(data: bytes) -> np.ndarray:
    """JPEG or PNG bytes -> RGB uint8 [H, W, 3] (`tf.io.decode_image(...,
    channels=3, expand_animations=False)` for the formats RLDS data holds)."""
    head = bytes(data[:8])
    if head.startswith(b"\xff\xd8"):
        return jpeg_decode(data)
    if head.startswith(_PNG_SIG):
        return png_decode(data)
    raise CodecError(f"unknown image format (first bytes {head.hex()}): only JPEG and PNG are read")


# ---------------------------------------------------------------------------
# TFRecord checksum
# ---------------------------------------------------------------------------

def crc32c(data) -> int:
    buf = _buf(data)
    return int(library().crc32c(buf.ctypes.data, buf.size))


def masked_crc32c(data) -> int:
    """TFRecord's masked CRC32C: rotate right by 15, add 0xa282ead8."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# frame transforms
# ---------------------------------------------------------------------------

class JitterDraws(NamedTuple):
    """The six draws of one augment (`_crop_resize_jitter_tf`'s seeds): crop
    area in [0.8, 1], crop offsets in [0, 1), brightness in [-0.1, 0.1],
    contrast and saturation in [0.9, 1.1], hue shift in [-0.05, 0.05]."""
    scale: float
    off_y: float
    off_x: float
    brightness: float
    contrast: float
    saturation: float
    hue: float

    @classmethod
    def sample(cls, rng: np.random.Generator) -> "JitterDraws":
        u = rng.random(7, dtype=np.float32)
        lo = np.array([0.8, 0.0, 0.0, -0.1, 0.9, 0.9, -0.05], np.float32)
        hi = np.array([1.0, 1.0, 1.0, 0.1, 1.1, 1.1, 0.05], np.float32)
        return cls(*(float(v) for v in lo + (hi - lo) * u))


def _frame(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim != 3 or img.dtype != np.uint8:
        raise ValueError(f"expected a [H, W, C] uint8 frame, got {img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def resize_lanczos3(img: np.ndarray, size: tuple[int, int], antialias: bool = False,
                    round_even: bool = False) -> np.ndarray:
    """`tf.image.resize(img, size, "lanczos3", antialias)`, clipped to [0, 255]
    and truncated to uint8 (the data path's `decode_and_resize_tf`), or
    rounded half to even first (`tf.round`, the Octo adapter's)."""
    img = _frame(img)
    out = np.empty((size[0], size[1], img.shape[2]), np.uint8)
    _check(library().resize_lanczos3_u8(img.ctypes.data, *img.shape, out.ctypes.data, size[0], size[1],
                                        int(antialias), int(round_even)))
    return out


def resize_lanczos4(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, (size[1], size[0]), interpolation=cv2.INTER_LANCZOS4)`
    for uint8 frames, bit for bit."""
    img = _frame(img)
    out = np.empty((size[0], size[1], img.shape[2]), np.uint8)
    _check(library().resize_lanczos4_cv_u8(img.ctypes.data, *img.shape, out.ctypes.data, size[0], size[1]))
    return out


def crop_resize_jitter(img: np.ndarray, size: tuple[int, int], draws: JitterDraws) -> np.ndarray:
    img = _frame(img)
    if img.shape[2] != 3:
        raise ValueError("crop_resize_jitter takes RGB frames")
    out = np.empty((size[0], size[1], 3), np.uint8)
    _check(library().crop_resize_jitter_u8(img.ctypes.data, img.shape[0], img.shape[1], out.ctypes.data, size[0],
                                           size[1], *(float(d) for d in draws)))
    return out


_F = np.float32


def _lanczos3(x: np.ndarray) -> np.ndarray:
    pi, r = _F(3.14159265359), _F(3.0)
    x = np.abs(x).astype(_F)
    with np.errstate(divide="ignore", invalid="ignore"):
        v = r * np.sin(pi * x) * np.sin(pi * x / r) / (pi * pi * x * x)
    return np.where(x > r, _F(0), np.where(x <= _F(1e-3), _F(1), v)).astype(_F)


def _spans(out_size: int, in_size: int):
    inv = _F(1.0 / float(_F(out_size) / _F(in_size)))
    span = min(7, in_size)
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, span), _F)
    for x in range(out_size):
        f = (_F(x) + _F(0.5)) * inv
        if f < 0 or f > in_size:
            continue
        lo = min(max(int(np.ceil(f - _F(3) - _F(0.5))), 0), in_size - 1)
        hi = min(max(int(np.floor(f + _F(3) - _F(0.5))), 0), in_size - 1) + 1
        w = _lanczos3(np.arange(lo, hi, dtype=_F) + _F(0.5) - f)
        total = _F(0)
        for v in w:
            total = _F(total + v)
        if abs(total) >= 1000.0 * np.finfo(_F).tiny:
            weights[x, :hi - lo] = w * (_F(1) / total)
        starts[x] = lo
    return starts, weights, span


def resize_lanczos3_reference(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    img = np.asarray(img, np.uint8).astype(_F)
    sh, sw, c = img.shape
    rs, rw, rspan = _spans(size[0], sh)
    cs, cw, cspan = _spans(size[1], sw)
    mid = np.zeros((size[0], sw, c), _F)
    for y in range(size[0]):
        for k in range(min(rs[y] + rspan, sh) - rs[y]):
            mid[y] = mid[y] + rw[y, k] * img[rs[y] + k]
    out = np.zeros((size[0], size[1], c), _F)
    for x in range(size[1]):
        for k in range(min(cs[x] + cspan, sw) - cs[x]):
            out[:, x] = out[:, x] + cw[x, k] * mid[:, cs[x] + k]
    return np.clip(out, 0, 255).astype(np.uint8)


def crop_resize_jitter_reference(img: np.ndarray, size: tuple[int, int], draws: JitterDraws) -> np.ndarray:
    img = np.asarray(img, np.uint8)
    sh, sw, _ = img.shape
    dh, dw = size
    d = [_F(v) for v in draws]
    h, w = _F(sh), _F(sw)
    side = np.sqrt(d[0])
    ch, cw = np.floor(h * side), np.floor(w * side)
    oy, ox = np.floor(d[1] * (h - ch + _F(1))), np.floor(d[2] * (w - cw + _F(1)))
    y1, x1 = oy / (h - _F(1)), ox / (w - _F(1))
    y2, x2 = (oy + ch - _F(1)) / (h - _F(1)), (ox + cw - _F(1)) / (w - _F(1))
    hsc = (y2 - y1) * _F(sh - 1) / _F(dh - 1) if dh > 1 else _F(0)
    wsc = (x2 - x1) * _F(sw - 1) / _F(dw - 1) if dw > 1 else _F(0)
    in_y = y1 * _F(sh - 1) + np.arange(dh, dtype=_F) * hsc if dh > 1 else np.full(dh, _F(0.5) * (y1 + y2) * _F(sh - 1))
    in_x = x1 * _F(sw - 1) + np.arange(dw, dtype=_F) * wsc if dw > 1 else np.full(dw, _F(0.5) * (x1 + x2) * _F(sw - 1))
    yin, xin = (in_y >= 0) & (in_y <= sh - 1), (in_x >= 0) & (in_x <= sw - 1)
    ty, by = np.where(yin, np.floor(in_y), 0).astype(int), np.where(yin, np.ceil(in_y), 0).astype(int)
    lx, rx = np.where(xin, np.floor(in_x), 0).astype(int), np.where(xin, np.ceil(in_x), 0).astype(int)
    yl = (in_y - np.floor(in_y)).astype(_F)[:, None, None]
    xl = (in_x - np.floor(in_x)).astype(_F)[None, :, None]
    src = img.astype(_F)
    top = src[ty][:, lx] + (src[ty][:, rx] - src[ty][:, lx]) * xl
    bot = src[by][:, lx] + (src[by][:, rx] - src[by][:, lx]) * xl
    x = np.where((yin[:, None] & xin[None, :])[..., None], top + (bot - top) * yl, _F(0))
    x = (x / _F(255) + d[3]).astype(_F)
    mean = (x.astype(np.float64).sum(axis=(0, 1)) / (dh * dw)).astype(_F)
    x = np.clip((x - mean) * d[4] + mean, _F(0), _F(1)).astype(_F)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(r, np.maximum(g, b))
    rng = v - np.minimum(r, np.minimum(g, b))
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(v > 0, rng / v, _F(0)).astype(_F)
        norm = (_F(1) / rng) * (_F(1) / _F(6))
        hh = np.where(r == v, norm * (g - b),
                      np.where(g == v, norm * (b - r) + _F(2) / _F(6), norm * (r - g) + _F(4) / _F(6)))
    hh = np.where(rng > 0, hh, _F(0)).astype(_F)
    hh = np.where(hh < 0, hh + _F(1), hh).astype(_F)
    hm = np.fmod(hh + d[6], _F(1)).astype(_F)
    hm = np.where((hm != 0) & (hm < 0), hm + _F(1), hm).astype(_F)
    s = np.clip(s * d[5], _F(0), _F(1)).astype(_F)
    dh6 = hm * _F(6)
    dr = np.clip(np.abs(dh6 - _F(3)) - _F(1), 0, 1)
    dg = np.clip(-np.abs(dh6 - _F(2)) + _F(2), 0, 1)
    db = np.clip(-np.abs(dh6 - _F(4)) + _F(2), 0, 1)
    one_s = -s + _F(1)
    out = np.stack([(one_s + s * dr) * v, (one_s + s * dg) * v, (one_s + s * db) * v], -1).astype(_F)
    return (np.clip(out, _F(0), _F(1)) * _F(255)).astype(np.uint8)
