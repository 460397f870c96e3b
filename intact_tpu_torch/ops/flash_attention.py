"""Prefix attention: the hand-written CUDA kernel (csrc/flash_attention.cu) and its plain version.

Replaces intact_tpu/ops/pallas_attention.py::flash_attention. Semantics:
fp32 logits `Q K^T * scale`, an arbitrary bool mask (False -> BIG_NEG),
fp32 softmax with fully masked rows giving 0, probabilities cast to V's dtype,
P·V accumulated in fp32 and returned in q's dtype; KV head = q_head // group.

The kernel (sm_90a) is warp-specialised: TMA loads of Q and of K/V tiles
into an mbarrier ring, wgmma for Q K^T and P V with an online softmax over
key tiles, a persistent grid over 128-row work items of one (batch, KV head),
and a TMA store of the output. It takes bf16 q/k/v, head_dim 64, 128 or 256,
any T, S and KVH with a query group H / KVH that divides 64, and contiguous,
16-byte aligned tensors; `_check` raises on anything else.

`flash_attention` launches the kernel for CUDA tensors (or raises: there is
no fallback) and runs `flash_attention_reference` for CPU tensors.
`flash_attention.launches` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from intact_tpu_torch.ops import build

BIG_NEG = -2.3819763e38  # most negative fp32 that keeps bf16 finite after cast

_HEAD_DIMS = (64, 128, 256)
_ROWS_PER_TILE = 64  # a warpgroup's Q tile: whole query groups of 64 / G tokens


def flash_attention_reference(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, KVH, D]
    v: torch.Tensor,  # [B, S, KVH, D]
    mask: torch.Tensor | None = None,  # bool [B, T, S]
    scale: float | None = None,
) -> torch.Tensor:
    """Plain-torch version of the kernel, with the kernel's zero rows."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    scale = d**-0.5 if scale is None else scale
    if mask is None:
        mask = torch.ones((b, t, s), dtype=torch.bool, device=q.device)
    qg = q.reshape(b, t, kvh, h // kvh, d)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    m = mask[:, None, None, :, :]
    logits = torch.where(m, logits, BIG_NEG)
    row_max = logits.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(logits - row_max) * m
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    # P in V's dtype, product accumulated in fp32 (exact bf16 products)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def _check(q, k, v, mask):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,T,H,D], k/v [B,S,KVH,D]; got {q.shape}, {k.shape}, {v.shape}")
    b, t, h, d = q.shape
    _, s, kvh, dk = k.shape
    if k.shape[0] != b or dk != d or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not fit together")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 q/k/v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {_HEAD_DIMS}; got {d}")
    if _ROWS_PER_TILE % (h // kvh):
        raise ValueError(f"the CUDA kernel takes a query group H/KVH that divides {_ROWS_PER_TILE}; got {h // kvh}")
    tensors = [q, k, v] + ([mask] if mask is not None else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, k, v and mask must lie on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the CUDA kernel needs 16-byte aligned q/k/v")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (b, t, s)):
        raise ValueError(f"mask must be bool [B, T, S] = {(b, t, s)}; got {mask.dtype} {tuple(mask.shape)}")


def _lib():
    lib = build.load("flash_attention")
    if not getattr(lib, "_intact_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.intact_flash_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        lib.intact_flash_attention.restype = i
        lib.intact_cuda_error_string.argtypes = [i]
        lib.intact_cuda_error_string.restype = ctypes.c_char_p
        lib._intact_typed = True
    return lib


def flash_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, KVH, D]
    v: torch.Tensor,  # [B, S, KVH, D]
    mask: torch.Tensor | None = None,  # bool [B, T, S]
    scale: float | None = None,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    _check(q, k, v, mask)
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    scale = d**-0.5 if scale is None else scale
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    dev = q.device.index
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr() if mask is not None else None, out.data_ptr(),
            b, t, s, h, kvh, d, float(scale), torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch.cuda.current_device():
        err = lib.intact_flash_attention(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.intact_flash_attention(*args)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: {lib.intact_cuda_error_string(err).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
