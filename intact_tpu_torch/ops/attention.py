"""Attention: plain grouped-einsum path + the hand-written prefix kernel.

Shapes follow the reference's [B, T, H, D] layout with grouped-query support
(PaliGemma/Gemma: 8 query heads over 1 KV head). Logits and softmax are
fp32; the probabilities are cast to V's dtype before the P·V product.

impl="xla":    grouped einsum + masked softmax in plain torch ops. The name
               is kept from the reference config; it means "the plain path".
impl="pallas": the hand-written CUDA kernel (ops/flash_attention.py) on a
               CUDA tensor, its plain version on a CPU tensor. Where a
               gradient is required it goes through `FlashAttentionFn`:
               the kernel's forward, and the plain path's backward
               recomputed from q, k, v and the mask (the kernel has no
               backward, as the Pallas kernel had none).

Not `scaled_dot_product_attention`: its fully-masked-row and precision
semantics differ from the reference's.
"""

from __future__ import annotations

import torch

from intact_tpu_torch.ops.flash_attention import BIG_NEG, flash_attention

__all__ = ["BIG_NEG", "FlashAttentionFn", "multi_head_attention", "xla_attention", "xla_attention_cached"]


def _grouped_logits(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    # fp32 logits from (possibly bf16) inputs: the products are exact in
    # fp32, so upcasting first matches an fp32-accumulating matmul
    return torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())


def _grouped_pv(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)


def xla_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, KVH, D]
    v: torch.Tensor,  # [B, S, KVH, D]
    mask: torch.Tensor | None,  # bool[B, T, S] (True = attend)
    scale: float | None = None,
) -> torch.Tensor:
    """Masked GQA attention. K/V are never repeated over the query groups:
    head i uses KV head i // group. A fully masked row softmaxes BIG_NEG
    logits into a uniform average of V (the reference's behaviour)."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    scale = d**-0.5 if scale is None else scale
    qg = (q * scale).reshape(b, t, kvh, h // kvh, d)
    logits = _grouped_logits(qg, k)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, BIG_NEG)
    probs = torch.softmax(logits, dim=-1)
    return _grouped_pv(probs, v).reshape(b, t, h, d)


def xla_attention_cached(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [B, S1, KVH, D] constant across decode steps
    v_cache: torch.Tensor,  # [B, S1, KVH, D]
    k_new: torch.Tensor,  # [B, S2, KVH, D] fresh keys this step
    v_new: torch.Tensor,  # [B, S2, KVH, D]
    mask_cache: torch.Tensor,  # bool[B, T, S1]
    mask_new: torch.Tensor,  # bool[B, T, S2]
    scale: float | None = None,
) -> torch.Tensor:
    """Attention over [cache; new] K/V WITHOUT concatenating the K/V.

    Equal to `xla_attention(q, cat(k_cache, k_new), ..., cat(masks))`:
    logits against each part, one softmax over the union, and the sum of
    the two probability-weighted values. Concatenating the cache with the
    fresh keys inside the Euler loop would copy the whole constant prefix
    cache on every layer of every step.
    """
    b, t, h, d = q.shape
    kvh = k_cache.shape[2]
    scale = d**-0.5 if scale is None else scale
    qg = (q * scale).reshape(b, t, kvh, h // kvh, d)
    lc = _grouped_logits(qg, k_cache)
    ln = _grouped_logits(qg, k_new)
    lc = torch.where(mask_cache[:, None, None, :, :], lc, BIG_NEG)
    ln = torch.where(mask_new[:, None, None, :, :], ln, BIG_NEG)
    probs = torch.softmax(torch.cat([lc, ln], dim=-1), dim=-1)
    s1 = k_cache.shape[1]
    out = _grouped_pv(probs[..., :s1], v_cache) + _grouped_pv(probs[..., s1:], v_new)
    return out.reshape(b, t, h, d)


class FlashAttentionFn(torch.autograd.Function):
    """Counterpart of intact_tpu/ops/attention.py::pallas_attention_diff:
    the flash forward, and the gradient of the plain `xla_attention`
    recomputed from the saved q, k, v and mask. The two agree wherever a
    query row attends to at least one key (the Pi0 masks have no fully
    masked rows)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        ctx.save_for_backward(q, k, v, mask)
        ctx.scale = scale
        return flash_attention(q, k, v, mask, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            out = xla_attention(*qkv, mask, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, qkv, grad_out)
        return dq, dk, dv, None, None


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    impl: str = "xla",
    scale: float | None = None,
) -> torch.Tensor:
    if impl == "pallas":
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
            scale = q.shape[-1] ** -0.5 if scale is None else scale
            return FlashAttentionFn.apply(q, k, v, mask, scale)
        return flash_attention(q, k, v, mask, scale)
    if impl != "xla":
        raise ValueError(f"unknown attention impl: {impl!r}")
    return xla_attention(q, k, v, mask, scale)
