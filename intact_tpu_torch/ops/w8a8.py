"""W8A8 matrix product: the hand-written CUDA kernel (csrc/w8a8_matmul.cu) and its plain version.

Replaces intact_tpu/ops/pallas_int8.py::w8a8_matmul and the XLA branch of
intact_tpu/models/common.py::_dense_int8. For x [..., K] (bf16 or fp32),
int8 weights wq and fp32 per-output-channel scales wscale [N]:

  xs  = max(absmax of x over a row's K-chunk, 1e-6) * fl(1/127)  (fp32, per row and chunk)
  xq  = round_half_even(x / xs)                                  (int8)
  acc = fma(float(int32 product of the chunk), xs, acc) over the chunks, from 0
  y   = acc * wscale, or fma(acc, wscale, bias) with an fp32 bias; cast to out_dtype

`weight_layout` says how wq is stored: "kn" is [K, N] (the reference's and
the Pallas kernel's form), "nk" is [N, K], K-major, the form the port's
quantized trees hold (`models/common.py::quantize_dense`) and the kernel
reads. The kernel takes "nk" codes as they are when their row stride is a
multiple of 16 bytes; the "kn" form, or an unaligned K, costs a K-major copy
per call (tests and checks only: the serving path never takes it).

`k_chunk=None` takes the whole K as one chunk: `_dense_int8`'s per-row
semantics, the main path. `k_chunk=2048` gives the Pallas kernel's
per-(row, chunk) semantics, with its chunk min(k_chunk, round_up(K, 128));
the two agree wherever K <= 2048. The bias (optional) is added in fp32
before the cast, as `_dense_int8` does; the Pallas kernel takes none.

These are the fp32 steps the reference computes whenever it runs compiled
(the jitted sampler, jax.jit(quantize_params), the Pallas kernel): XLA
rewrites its `/ 127.0` into a multiply by the fp32 reciprocal and contracts
the chunk fold `o + acc * xs` and the bias add `y * ws + b` into fused
multiply-adds. Only an op-by-op call divides and rounds twice. x / xs is a
true division. The plain version forms each fused multiply-add in float64
(exact product, then one rounding to fp32 of a float64 sum, which differs from
a true fma only when that sum lands on an fp32 tie: about 2^-29 of values).

The row-parallel entry (tensor parallelism, models/common.py::_dense_int8_row):
a rank holds K / t of a product's input rows and x's matching columns, so
its own absmax would give each row another scale than one card's.
`row_absmax` forms the rank's per-row absmax, the caller takes its max over
the ranks, `w8a8_partial` quantizes x against that whole-row scale and
returns the exact int32 partial product [M, N] (the split mode's workspace,
without its finish pass) with the row scales, the caller sums the ranks'
partials, and `w8a8_finish` runs the finish pass: acc = fma(float(sum), xs,
0), y = acc * wscale or fma(acc, wscale, bias). Integer sums are exact and
the fp32 steps are the per-row mode's, so the product is bit-equal to
`w8a8_matmul` on the whole row. The per-(row, K-chunk) mode needs no such
entry where the slices fall on chunk boundaries: each chunk's scale is then
one rank's alone. The two wrappers count their own launches
(`w8a8_partial.launches`, `w8a8_finish.launches`), and their plain versions
are `w8a8_partial_reference` and `w8a8_finish_reference`.

`plan` chooses the kernel's mode from the shape: 128 x 256 output tiles
(per row) or 128 x 128 (per chunk) where the tiles fill the card, else K
split across blocks with exact int32 partial sums (the expert's small-M
products). `w8a8_matmul` launches the kernel for CUDA tensors (or raises:
there is no fallback) and runs `w8a8_matmul_reference` for CPU tensors.
`w8a8_matmul.launches` counts kernel launches (one per call, covering its
quantize, product and, when split, finish passes), and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from intact_tpu_torch.ops import build

PALLAS_BLOCK_K = 2048  # the Pallas kernel's K chunk (pallas_int8.BLOCK_K)
K_TILE = 64  # the quantized K granule: chunks are multiples of it
STAGE_K = 128  # the product's K bytes per pipeline stage (one 128-byte swizzled row)
BLOCK_M = 128  # output rows per block (two warpgroups of 64)
BLOCK_N = {"row": 256, "chunk": 128, "split": 128}  # output columns per block, by mode
NUM_SMS = 132  # H100 SXM
WEIGHT_LAYOUTS = ("kn", "nk")
INV127 = float(np.float32(1.0) / np.float32(127.0))  # fl(1/127), XLA's folded reciprocal


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def chunk_length(k: int, k_chunk: int | None) -> int | None:
    """The K chunk the quantization uses: None for the whole K, else the
    Pallas kernel's min(k_chunk, round_up(K, 128))."""
    if k_chunk is None:
        return None
    if k_chunk <= 0 or k_chunk % K_TILE:
        raise ValueError(f"k_chunk must be a positive multiple of {K_TILE}; got {k_chunk}")
    return min(k_chunk, _round_up(k, 128))


class Plan(NamedTuple):
    mode: str  # "row", "chunk" or "split"
    split_len: int  # K per block (K_pad when not split)
    n_splits: int


@functools.lru_cache(maxsize=1024)
def plan(m: int, n: int, k: int, k_chunk: int | None = None, n_sm: int = NUM_SMS) -> Plan:
    """The kernel's mode for an [m, k] x [k, n] product: output tiles of
    BLOCK_M x BLOCK_N[mode] where they fill the card, else K split across
    blocks (about one per SM: a block takes an SM's registers) in whole
    STAGE_K steps that, per chunk, hold whole chunks."""
    k_pad = _round_up(k, K_TILE)
    chunk = chunk_length(k, k_chunk)
    mode = "row" if chunk is None else "chunk"
    tiles = -(-m // BLOCK_M) * -(-n // BLOCK_N[mode])
    if tiles >= n_sm:
        return Plan(mode, k_pad, 1)
    p = _split_plan(m, n, k_pad, STAGE_K if chunk is None else math.lcm(STAGE_K, chunk), n_sm)
    return Plan(mode, k_pad, 1) if p.n_splits == 1 else p


def _split_plan(m: int, n: int, k_pad: int, unit: int, n_sm: int) -> Plan:
    """The split mode's plan: K in whole `unit`s split across blocks, about
    one block per SM over the output tiles."""
    tiles = -(-m // BLOCK_M) * -(-n // BLOCK_N["split"])
    n_units = -(-k_pad // unit)
    splits = max(1, min(n_units, -(-n_sm // tiles)))
    split_len = -(-n_units // splits) * unit
    return Plan("split", split_len, -(-k_pad // split_len))


def split_partials(xq: torch.Tensor, wq: torch.Tensor, k_chunk: int | None, p: Plan) -> torch.Tensor:
    """The split mode's int32 workspace [n_chunks, M, N] as the kernel fills it,
    in plain torch: every block's int32 partial product of its K range, added
    into the chunk its range lies in. xq [M, K] and wq [K, N] int8."""
    m, k = xq.shape
    chunk = chunk_length(k, k_chunk) or _round_up(k, K_TILE)
    n_chunks = -(-k // chunk)
    part = torch.zeros((n_chunks, m, wq.shape[1]), dtype=torch.int64, device=xq.device)
    for z in range(p.n_splits):
        lo, hi = z * p.split_len, min((z + 1) * p.split_len, k)
        for c0 in range(lo - lo % chunk, hi, chunk):  # the chunks the range meets
            a, b = max(lo, c0), min(hi, c0 + chunk)
            part[c0 // chunk] += xq[:, a:b].to(torch.int64) @ wq[a:b].to(torch.int64)
    return part.to(torch.int32)


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    # an operand tensor on the same device: CUDA divides by a Python scalar
    # as a multiply by its reciprocal, which can differ in the last bit
    return torch.full_like(like, value)


def quantize_reference(x: torch.Tensor, k_chunk: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] -> (xq [M, K] int8, xs [M, n_chunks] fp32): the plain
    activation quantization, per row or per (row, chunk)."""
    m, k = x.shape
    chunk = chunk_length(k, k_chunk) or k
    n_chunks = -(-k // chunk)
    x32 = x.to(torch.float32)
    padded = torch.nn.functional.pad(x32, (0, n_chunks * chunk - k)).reshape(m, n_chunks, chunk)
    amax = padded.abs().amax(dim=-1)  # NaN propagates, as in jnp.max
    xs = torch.maximum(amax, _full(amax, 1e-6)) * _full(amax, INV127)
    xq = torch.round(padded / xs[..., None]).to(torch.int8)  # round half to even
    return xq.reshape(m, n_chunks * chunk)[:, :k], xs


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 a * b + c with one rounding of the exact product's sum, formed in
    float64 (the product of two fp32 values is exact there)."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 a [M, K] and b [K, N], as fp32 values
    rounded to nearest (jnp's int32 -> fp32 cast): an int64 matmul on the
    CPU, a float64 one on the card (exact: |sum| <= K * 127^2 < 2^53)."""
    if a.device.type == "cpu":
        return (a.to(torch.int64) @ b.to(torch.int64)).to(torch.float32)
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.float32)


def w8a8_matmul_reference(
    x: torch.Tensor,  # [..., K]
    wq: torch.Tensor,  # [K, N] int8
    wscale: torch.Tensor,  # [N]
    bias: torch.Tensor | None = None,  # [N]
    k_chunk: int | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain-torch version of the kernel, in the kernel's order of fp32
    operations: acc = 0; acc = fma(float(int sum), xs, acc) per chunk;
    y = acc * wscale or fma(acc, wscale, bias)."""
    lead, k = x.shape[:-1], x.shape[-1]
    out_dtype = out_dtype or x.dtype
    x2 = x.reshape(-1, k)
    xq, xs = quantize_reference(x2, k_chunk)
    chunk = chunk_length(k, k_chunk) or k
    acc = torch.zeros((x2.shape[0], wq.shape[1]), dtype=torch.float32, device=x.device)
    for c in range(xs.shape[1]):
        rows = slice(c * chunk, min((c + 1) * chunk, k))
        acc = _fma(int_product(xq[:, rows], wq[rows]), xs[:, c:c + 1], acc)
    ws = wscale.to(torch.float32)
    y = acc * ws if bias is None else _fma(acc, ws, bias.to(torch.float32))
    return y.to(out_dtype).reshape(*lead, wq.shape[1])


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """fp32 [M]: each row's max |x| of x [M, K] (NaN propagates)."""
    return x.abs().amax(dim=-1).to(torch.float32)


def _row_scales(amax: torch.Tensor) -> torch.Tensor:
    return torch.maximum(amax, _full(amax, 1e-6)) * _full(amax, INV127)


def w8a8_partial_reference(x: torch.Tensor, wq: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] against wq [K, N] int8, quantized with the given row absmax
    amax [M] -> (int32 [M, N], the exact product of the codes; xs [M] fp32)."""
    xs = _row_scales(amax.to(torch.float32))
    xq = torch.round(x.to(torch.float32) / xs[:, None]).to(torch.int8)  # round half to even
    if x.device.type == "cpu":
        part = xq.to(torch.int64) @ wq.to(torch.int64)
    else:
        part = xq.to(torch.float64) @ wq.to(torch.float64)
    return part.to(torch.int32), xs


def w8a8_finish_reference(part: torch.Tensor, xs: torch.Tensor, wscale: torch.Tensor,
                          bias: torch.Tensor | None = None, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The finish pass in plain torch: acc = fma(float(part), xs, 0); y = acc *
    wscale or fma(acc, wscale, bias); cast."""
    acc = _fma(part.to(torch.float32), xs[:, None], torch.zeros_like(part, dtype=torch.float32))
    ws = wscale.to(torch.float32)
    y = acc * ws if bias is None else _fma(acc, ws, bias.to(torch.float32))
    return y.to(out_dtype)


_IO_DTYPES = (torch.bfloat16, torch.float32)


def _dims(wq: torch.Tensor, weight_layout: str) -> tuple[int, int]:
    """(K, N) of wq in its layout."""
    if weight_layout not in WEIGHT_LAYOUTS:
        raise ValueError(f"weight_layout must be one of {WEIGHT_LAYOUTS}; got {weight_layout!r}")
    if wq.ndim != 2 or wq.dtype != torch.int8:
        raise TypeError(f"wq must be a 2-D int8 tensor; got {wq.dtype} {tuple(wq.shape)}")
    return tuple(wq.shape) if weight_layout == "kn" else tuple(wq.shape[::-1])


def _check(x, wq, wscale, bias, out_dtype, weight_layout) -> tuple[int, int]:
    """-> (K, N), or raise on what the kernel does not take."""
    k, n = _dims(wq, weight_layout)
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not fit wq {tuple(wq.shape)} ({weight_layout})")
    if x.dtype not in _IO_DTYPES or out_dtype not in _IO_DTYPES:
        raise TypeError(f"the CUDA kernel takes and returns bf16 or fp32; got x {x.dtype}, out {out_dtype}")
    if wscale.shape != (n,) or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"wscale and bias must be [N] = [{n}]")
    tensors = [x, wq, wscale] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, wq, wscale and bias must lie on one device")
    if weight_layout == "nk" and wq.stride(1) != 1:
        raise ValueError("the CUDA kernel takes [N, K] codes with contiguous rows")
    if weight_layout == "kn" and not wq.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous [K, N] wq")
    return k, n


def kmajor(wq: torch.Tensor, weight_layout: str) -> tuple[torch.Tensor, int]:
    """The codes as the kernel reads them, [N, K] with a row stride (bytes) of
    a multiple of 16 on a 16-byte aligned base -> (codes, row stride): the
    "nk" codes themselves where they already are so, else a zero-padded
    K-major copy."""
    k, n = _dims(wq, weight_layout)
    if weight_layout == "nk" and wq.stride(1) == 1 and wq.stride(0) % 16 == 0 and wq.data_ptr() % 16 == 0:
        return wq, wq.stride(0)
    w = torch.zeros((n, _round_up(k, 16)), dtype=torch.int8, device=wq.device)
    w[:, :k] = wq if weight_layout == "nk" else wq.t()
    return w, w.shape[1]


_MODES = {"row": 0, "chunk": 1, "split": 2}


@functools.lru_cache(maxsize=1024)
def partial_plan(m: int, n: int, k: int, n_sm: int = NUM_SMS) -> Plan:
    """The row-parallel product's plan: always the split mode (its int32
    workspace is the partial product), K split across blocks as `plan`
    splits it where the output tiles do not fill the card, in one piece
    where they do."""
    return _split_plan(m, n, _round_up(k, K_TILE), STAGE_K, n_sm)


def _lib():
    lib = build.load("w8a8_matmul")
    if not getattr(lib, "_intact_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.intact_w8a8_matmul.argtypes = [p, i, p, ctypes.c_longlong, p, p, p, i, p, p, p,
                                           i, i, i, i, i, i, i, i, i, p]
        lib.intact_w8a8_matmul.restype = i
        lib.intact_w8a8_partial.argtypes = [p, i, p, ctypes.c_longlong, p, p, p, p, i, i, i, i, i, i, p]
        lib.intact_w8a8_partial.restype = i
        lib.intact_w8a8_finish.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.intact_w8a8_finish.restype = i
        lib.intact_cuda_error_string.argtypes = [i]
        lib.intact_cuda_error_string.restype = ctypes.c_char_p
        lib._intact_typed = True
    return lib


def w8a8_matmul(
    x: torch.Tensor,  # [..., K] bf16 or fp32
    wq: torch.Tensor,  # int8 [K, N] ("kn") or [N, K] ("nk")
    wscale: torch.Tensor,  # [N] fp32
    bias: torch.Tensor | None = None,  # [N]
    k_chunk: int | None = None,
    out_dtype: torch.dtype | None = None,
    weight_layout: str = "kn",
) -> torch.Tensor:
    """-> [..., N] in out_dtype (x's dtype by default)."""
    if x.device.type == "cpu":
        _dims(wq, weight_layout)
        w = wq if weight_layout == "kn" else wq.t()
        return w8a8_matmul_reference(x, w, wscale, bias, k_chunk, out_dtype)
    return _run(x, wq, wscale, bias, k_chunk, out_dtype, weight_layout)[0]


@functools.lru_cache(maxsize=1024)
def _geometry(k: int, k_chunk: int | None) -> tuple[int, int, int]:
    """(K_pad, chunk, n_chunks) of the kernel for K and k_chunk."""
    k_pad = _round_up(k, K_TILE)
    chunk = chunk_length(k, k_chunk) or k_pad
    return k_pad, chunk, -(-k // chunk)


def launch(x, wq, wscale, bias=None, k_chunk=None, out_dtype=None, weight_layout="kn"):
    """Launch the kernel on CUDA tensors -> (y [..., N], xq [M, K_pad] int8
    codes, xs [M, n_chunks] scales): the activation codes and scales are the
    kernel's own scratch, returned for checks."""
    out, scratch, (m, k_pad, n_chunks, xs_off) = _run(x, wq, wscale, bias, k_chunk, out_dtype, weight_layout)
    xq = scratch[:m * k_pad].view(torch.int8).view(m, k_pad)
    xs = scratch[xs_off:xs_off + m * n_chunks * 4].view(torch.float32).view(m, n_chunks)
    return out, xq, xs


def _run(x, wq, wscale, bias, k_chunk, out_dtype, weight_layout):
    # the host work per call is two allocations and one library call: the
    # serving path makes about 1,500 calls per inference
    if x.device.type != "cuda":
        raise ValueError(f"the w8a8_matmul kernel runs on CUDA tensors, not {x.device}")
    out_dtype = out_dtype or x.dtype
    k, n = _check(x, wq, wscale, bias, out_dtype, weight_layout)
    x = x if x.is_contiguous() else x.contiguous()
    m = x.numel() // k
    k_pad, chunk, n_chunks = _geometry(k, k_chunk)
    out = torch.empty((*x.shape[:-1], n), dtype=out_dtype, device=x.device)
    dev = x.device.index
    p = plan(m, n, k, k_chunk, _sm_count(dev)) if m else None
    # scratch: codes xq [M, K_pad] int8, scales xs [M, n_chunks] fp32 and, when
    # split, the int32 workspace [n_chunks, M, N], 256-byte aligned each
    xs_off = _round_up(m * k_pad, 256)
    part_off = _round_up(xs_off + m * n_chunks * 4, 256)
    nbytes = part_off + (4 * n_chunks * m * n if p is not None and p.mode == "split" else 0)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    if out.numel():
        w, w_stride = kmajor(wq, weight_layout)
        ws = wscale if wscale.dtype == torch.float32 and wscale.is_contiguous() else wscale.float().contiguous()
        if bias is not None and not (bias.dtype == torch.float32 and bias.is_contiguous()):
            bias = bias.float().contiguous()
        base = scratch.data_ptr()
        args = (x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), w_stride, ws.data_ptr(),
                bias.data_ptr() if bias is not None else None, out.data_ptr(), int(out_dtype == torch.bfloat16),
                base, base + xs_off, base + part_off, m, k, n, k_pad, chunk, n_chunks, _MODES[p.mode],
                p.split_len, p.n_splits, torch._C._cuda_getCurrentRawStream(dev))
        _call(dev, _lib().intact_w8a8_matmul, *args)
        w8a8_matmul.launches += 1
    return out, scratch, (m, k_pad, n_chunks, xs_off)


def _call(dev: int, fn, *args) -> None:
    lib = _lib()
    if dev == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: {lib.intact_cuda_error_string(err).decode()}")


def w8a8_partial(
    x: torch.Tensor,  # [M, K] bf16 or fp32: this rank's columns of the rows
    wq: torch.Tensor,  # int8 [K, N] ("kn") or [N, K] ("nk"): this rank's input rows
    amax: torch.Tensor,  # [M] fp32: each row's absmax over the whole row
    weight_layout: str = "kn",
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int32 [M, N], the exact partial product of x's codes quantized
    against amax; xs [M] fp32, the row scales). Launches the kernel's
    row-parallel pass on CUDA tensors (or raises), its plain version on CPU
    tensors."""
    if x.ndim != 2 or amax.shape != (x.shape[0],):
        raise ValueError(f"x must be [M, K] and amax [M]; got {tuple(x.shape)}, {tuple(amax.shape)}")
    if x.device.type == "cpu":
        _dims(wq, weight_layout)
        return w8a8_partial_reference(x, wq if weight_layout == "kn" else wq.t(), amax)
    if x.device.type != "cuda":
        raise ValueError(f"the w8a8_partial kernel runs on CUDA tensors, not {x.device}")
    k, n = _dims(wq, weight_layout)
    if x.shape[-1] != k or x.dtype not in _IO_DTYPES or amax.device != x.device or wq.device != x.device:
        raise ValueError(f"x {x.dtype} {tuple(x.shape)} does not fit wq {tuple(wq.shape)} ({weight_layout}) on one device")
    x = x if x.is_contiguous() else x.contiguous()
    amax = amax.to(torch.float32).contiguous()
    m = x.shape[0]
    k_pad = _round_up(k, K_TILE)
    dev = x.device.index
    part = torch.empty((m, n), dtype=torch.int32, device=x.device)
    xs = torch.empty(m, dtype=torch.float32, device=x.device)
    if part.numel():
        p = partial_plan(m, n, k, _sm_count(dev))
        xq = torch.empty((m, k_pad), dtype=torch.int8, device=x.device)
        w, w_stride = kmajor(wq, weight_layout)
        _call(dev, _lib().intact_w8a8_partial, x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), w_stride,
              amax.data_ptr(), xq.data_ptr(), xs.data_ptr(), part.data_ptr(), m, k, n, k_pad, p.split_len, p.n_splits,
              torch._C._cuda_getCurrentRawStream(dev))
        w8a8_partial.launches += 1
    return part, xs


def w8a8_finish(
    part: torch.Tensor,  # [M, N] int32: the ranks' summed partial products
    xs: torch.Tensor,  # [M] fp32 row scales
    wscale: torch.Tensor,  # [N] fp32
    bias: torch.Tensor | None = None,  # [N]
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """-> [M, N] in out_dtype: the finish pass of the row-parallel product.
    Launches the kernel's finish pass on CUDA tensors (or raises), its plain
    version on CPU tensors."""
    m, n = part.shape
    if part.dtype != torch.int32 or xs.shape != (m,) or wscale.shape != (n,) or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"part must be int32 [M, N], xs [M], wscale and bias [N]; got {tuple(part.shape)}")
    if part.device.type == "cpu":
        return w8a8_finish_reference(part, xs, wscale, bias, out_dtype)
    if part.device.type != "cuda" or out_dtype not in _IO_DTYPES:
        raise ValueError(f"the w8a8_finish kernel runs on CUDA tensors into bf16 or fp32, not {part.device} {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=part.device)
    if out.numel():
        dev = part.device.index
        part = part.contiguous()
        ws = wscale.to(torch.float32).contiguous()
        b = bias.to(torch.float32).contiguous() if bias is not None else None
        _call(dev, _lib().intact_w8a8_finish, part.data_ptr(), xs.contiguous().data_ptr(), ws.data_ptr(),
              b.data_ptr() if b is not None else None, out.data_ptr(), int(out_dtype == torch.bfloat16), m, n,
              torch._C._cuda_getCurrentRawStream(dev))
        w8a8_finish.launches += 1
    return out


_SMS: dict = {}


def _sm_count(dev: int) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


w8a8_matmul.launches = 0
w8a8_partial.launches = 0
w8a8_finish.launches = 0
