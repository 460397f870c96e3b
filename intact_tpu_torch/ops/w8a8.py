"""W8A8 matrix product: the hand-written CUDA kernel (csrc/w8a8_matmul.cu) and its plain version.

Replaces intact_tpu/ops/pallas_int8.py::w8a8_matmul and the XLA branch of
intact_tpu/models/common.py::_dense_int8. For x [..., K] (bf16 or fp32),
int8 weights wq [K, N] and fp32 per-output-channel scales wscale [N]:

  xs  = max(absmax of x over a row's K-chunk, 1e-6) * fl(1/127)  (fp32, per row and chunk)
  xq  = round_half_even(x / xs)                                  (int8)
  acc = fma(float(int32 product of the chunk), xs, acc) over the chunks, from 0
  y   = acc * wscale, or fma(acc, wscale, bias) with an fp32 bias; cast to out_dtype

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

`w8a8_matmul` launches the kernel for CUDA tensors (or raises: there is no
fallback) and runs `w8a8_matmul_reference` for CPU tensors.
`w8a8_matmul.launches` counts kernel launches (one per call, covering its
quantize and product passes), and nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from intact_tpu_torch.ops import build

PALLAS_BLOCK_K = 2048  # the Pallas kernel's K chunk (pallas_int8.BLOCK_K)
K_TILE = 64  # the kernel's K step: chunks are multiples of it
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


_IO_DTYPES = (torch.bfloat16, torch.float32)


def _check(x, wq, wscale, bias, out_dtype):
    if wq.ndim != 2 or wq.dtype != torch.int8:
        raise TypeError(f"wq must be int8 [K, N]; got {wq.dtype} {tuple(wq.shape)}")
    k, n = wq.shape
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not fit wq {tuple(wq.shape)}")
    if x.dtype not in _IO_DTYPES or out_dtype not in _IO_DTYPES:
        raise TypeError(f"the CUDA kernel takes and returns bf16 or fp32; got x {x.dtype}, out {out_dtype}")
    if wscale.shape != (n,) or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"wscale and bias must be [N] = [{n}]")
    tensors = [x, wq, wscale] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, wq, wscale and bias must lie on one device")
    if not wq.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous wq")


def _lib():
    lib = build.load("w8a8_matmul")
    if not getattr(lib, "_intact_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.intact_w8a8_matmul.argtypes = [p, i, p, p, p, p, i, p, p, i, i, i, i, i, i, i, p]
        lib.intact_w8a8_matmul.restype = i
        lib.intact_cuda_error_string.argtypes = [i]
        lib.intact_cuda_error_string.restype = ctypes.c_char_p
        lib._intact_typed = True
    return lib


def w8a8_matmul(
    x: torch.Tensor,  # [..., K] bf16 or fp32
    wq: torch.Tensor,  # [K, N] int8
    wscale: torch.Tensor,  # [N] fp32
    bias: torch.Tensor | None = None,  # [N]
    k_chunk: int | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """-> [..., N] in out_dtype (x's dtype by default)."""
    if x.device.type == "cpu":
        return w8a8_matmul_reference(x, wq, wscale, bias, k_chunk, out_dtype)
    return launch(x, wq, wscale, bias, k_chunk, out_dtype)[0]


def launch(x, wq, wscale, bias=None, k_chunk=None, out_dtype=None):
    """Launch the kernel on CUDA tensors -> (y [..., N], xq [M, K_pad] int8
    codes, xs [M, n_chunks] scales): the activation codes and scales are the
    kernel's own scratch, returned for checks."""
    if x.device.type != "cuda":
        raise ValueError(f"the w8a8_matmul kernel runs on CUDA tensors, not {x.device}")
    out_dtype = out_dtype or x.dtype
    _check(x, wq, wscale, bias, out_dtype)
    lead, (k, n) = x.shape[:-1], wq.shape
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    k_pad = _round_up(k, K_TILE)
    chunk = chunk_length(k, k_chunk) or k_pad
    n_chunks = -(-k // chunk)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    xq = torch.empty((m, k_pad), dtype=torch.int8, device=x.device)
    xs = torch.empty((m, n_chunks), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.reshape(*lead, n), xq, xs
    ws = wscale.to(torch.float32).contiguous()
    b = bias.to(torch.float32).contiguous() if bias is not None else None
    aligned8 = int(n % 8 == 0 and wq.data_ptr() % 8 == 0)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.intact_w8a8_matmul(
            x2.data_ptr(), int(x2.dtype == torch.bfloat16), wq.data_ptr(), ws.data_ptr(),
            b.data_ptr() if b is not None else None, out.data_ptr(), int(out_dtype == torch.bfloat16),
            xq.data_ptr(), xs.data_ptr(), m, k, n, k_pad, chunk, n_chunks, aligned8,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"w8a8_matmul kernel launch failed: {lib.intact_cuda_error_string(err).decode()}")
    w8a8_matmul.launches += 1
    return out.reshape(*lead, n), xq, xs


w8a8_matmul.launches = 0
