"""Gemma decoder blocks for the Pi0 trunk: the PaliGemma VLM stream and the
smaller action-expert stream, which attends over the VLM's prefix K/V cache.

Entry points:
  forward_joint   training: prefix+suffix in one pass (no cache), the two
                  streams sharing one attention per layer
  prefill         the prefix through the VLM, emitting the K/V cache; under
                  autograd the prefix output alone (Pi0FAST training)
  decode          the suffix through the expert against the cached prefix K/V
                  (called once per Euler step)

Grouped-query attention: 8 query heads / 1 KV head / head_dim 256 for both
streams (widths differ: 2048 VLM vs 1024 expert). The prefix attention goes
through `multi_head_attention(impl=attention_impl)`, which reaches the
hand-written CUDA kernel for "pallas" (with the plain backward where a
gradient is required); decode's split-cache attention and the suffix-only last
layer of the joint pass stay on the plain path.

Over tensor ranks (Megatron-style, parallel/tensor.py; Pi0 at mesh.tensor >
1) each rank runs its local query heads: q, gate and up are column-parallel
(their inputs through `copy_in`), o and down row-parallel (their partials
all-reduced), and the attention takes the rank's H / t heads against the K/V
head. Pi0's one K/V head does not split: k and v are computed whole on every
tensor rank (their kernels replicated, their gradient summed over tensor by
the optimizer). Each entry point finds its tensor group in its parameters
(`tensor_parallel.of`), so a tree without tensor-split leaves runs as on one
card.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models.common import DEFAULT_POLICY, DtypePolicy
from intact_tpu_torch.ops.attention import multi_head_attention, xla_attention_cached
from intact_tpu_torch.ops.rope import apply_rope
from intact_tpu_torch.parallel import tensor as tensor_parallel


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    width: int
    depth: int
    mlp_dim: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    vocab_size: int = 257_152  # PaliGemma vocab
    rope_base: float = 10_000.0
    norm_eps: float = 1e-6


def gemma_2b() -> GemmaConfig:
    """PaliGemma-3B's language trunk."""
    return GemmaConfig(width=2048, depth=18, mlp_dim=16_384, num_heads=8, num_kv_heads=1, head_dim=256)


def gemma_300m_expert() -> GemmaConfig:
    """Pi0 action expert: same depth/heads as the VLM trunk, narrower width."""
    return GemmaConfig(width=1024, depth=18, mlp_dim=4096, num_heads=8, num_kv_heads=1, head_dim=256)


def tiny_test_config(width: int = 32, depth: int = 2) -> GemmaConfig:
    return GemmaConfig(
        width=width, depth=depth, mlp_dim=64, num_heads=2, num_kv_heads=1,
        head_dim=16, vocab_size=256,
    )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block_params(init: cm.Initializer, cfg: GemmaConfig, lead: tuple) -> cm.Params:
    """One Gemma block's weights, stacked over the `lead` axes."""
    d, m = cfg.width, cfg.mlp_dim
    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim
    return {
        "ln1": cm.rmsnorm_init(init, d, lead),
        "attn": {
            "q": cm.dense_init(init, d, qdim, use_bias=False, lead=lead),
            "k": cm.dense_init(init, d, kvdim, use_bias=False, lead=lead),
            "v": cm.dense_init(init, d, kvdim, use_bias=False, lead=lead),
            "o": cm.dense_init(init, qdim, d, use_bias=False, lead=lead),
        },
        "ln2": cm.rmsnorm_init(init, d, lead),
        "mlp": {
            "gate": cm.dense_init(init, d, m, use_bias=False, lead=lead),
            "up": cm.dense_init(init, d, m, use_bias=False, lead=lead),
            "down": cm.dense_init(init, m, d, use_bias=False, lead=lead),
        },
    }


def init_blocks_params(init: cm.Initializer, cfg: GemmaConfig) -> cm.Params:
    return {"blocks": init_block_params(init, cfg, (cfg.depth,)), "final_norm": cm.rmsnorm_init(init, cfg.width)}


def init_embed_params(init: cm.Initializer, cfg: GemmaConfig) -> cm.Params:
    return cm.embed_init(init, cfg.vocab_size, cfg.width)


def init_blocks(cfg: GemmaConfig, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    return init_blocks_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


def init_embed(cfg: GemmaConfig, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    return init_embed_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


# ---------------------------------------------------------------------------
# layer pieces
# ---------------------------------------------------------------------------

def _attention_region(bp, cfg: GemmaConfig, tp):
    """`tp` where the layer's query heads are split over tensor, else None."""
    return tensor_parallel.region(tp, bp["attn"]["q"], cfg.num_heads * cfg.head_dim)


def _kv(bp, x, positions, cfg: GemmaConfig, policy: DtypePolicy, tp=None):
    """K (roped) and V [B, T, KVH, head_dim]: this rank's K/V heads where they
    split over tensor, all of them where they do not (Pi0's one). x is the
    region's input, already through `copy_in` where a gradient flows."""
    b, t, _ = x.shape
    k = cm.dense_column(bp["attn"]["k"], x, policy, tp).reshape(b, t, -1, cfg.head_dim)
    v = cm.dense_column(bp["attn"]["v"], x, policy, tp).reshape(b, t, -1, cfg.head_dim)
    return apply_rope(k, positions, cfg.rope_base), v


def _qkv(bp, x, positions, cfg: GemmaConfig, policy: DtypePolicy, tp=None):
    """q (this rank's heads over tensor), k, v."""
    b, t, _ = x.shape
    tp = _attention_region(bp, cfg, tp)
    x = tensor_parallel.copy_in(x, tp)
    q = cm.dense_column(bp["attn"]["q"], x, policy, tp).reshape(b, t, -1, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_base)
    k, v = _kv(bp, x, positions, cfg, policy, tp)
    return q, k, v


def _post_attention(bp, x, att_out, cfg: GemmaConfig, policy: DtypePolicy, tp=None):
    """The out-projection (row-parallel over split heads) and the gated MLP
    (gate and up column-, down row-parallel where split)."""
    b, t = att_out.shape[:2]
    x = x + cm.dense_row(bp["attn"]["o"], att_out.reshape(b, t, -1), policy, _attention_region(bp, cfg, tp))
    y = cm.rms_norm(bp["ln2"], x, cfg.norm_eps)
    mlp = bp["mlp"]
    return x + cm.gemma_mlp(mlp, y, policy, tensor_parallel.region(tp, mlp["gate"], cfg.mlp_dim))


# ---------------------------------------------------------------------------
# forward modes
# ---------------------------------------------------------------------------

def _depth(blocks: cm.Params) -> int:
    return cm.tree_leaves(blocks)[0].shape[0]


def forward_joint(
    vlm_params: cm.Params,
    expert_params: cm.Params,
    x_pre: torch.Tensor,  # [B, P, D_vlm] embedded prefix
    x_suf: torch.Tensor,  # [B, S, D_exp] embedded suffix
    mask: torch.Tensor,  # bool[B, P+S, P+S] over the concatenated sequence
    positions: torch.Tensor,  # int[B, P+S]
    vlm_cfg: GemmaConfig,
    expert_cfg: GemmaConfig,
    policy: DtypePolicy = DEFAULT_POLICY,
    attention_impl: str = "xla",
    suffix_only: bool = False,
):
    """Training pass. Returns (prefix_out, suffix_out), both final-normed.

    Where a gradient is required each layer pair runs under
    `torch.utils.checkpoint`: the backward recomputes one layer at a time
    (its split weights gathered again), as the reference's per-layer remat
    does.

    suffix_only=True is for callers that discard prefix_out (Pi0's training
    loss reads only the action-chunk suffix): the last layer's prefix
    attention output, o-projection and MLP feed only prefix_out, so the last
    pair runs `joint_last_pair` (prefix: bare ln1 + K/V; suffix: the full
    layer). Gradients are unchanged. Returns (None, suffix_out).
    """
    p_len = x_pre.shape[1]
    pos_pre, pos_suf = positions[:, :p_len], positions[:, p_len:]
    tps = (tensor_parallel.of(vlm_params), tensor_parallel.of(expert_params))
    body = _joint_body(mask, pos_pre, pos_suf, vlm_cfg, expert_cfg, policy, attention_impl, tps)
    vb, eb = vlm_params["blocks"], expert_params["blocks"]
    depth = _depth(vb)
    n_full = depth if not suffix_only else depth - 1
    carry = (x_pre, x_suf)
    for i in range(n_full):
        carry = _remat_layer(body, carry, vb, eb, i)
    x_pre, x_suf = carry
    if not suffix_only:
        x_pre = cm.rms_norm(vlm_params["final_norm"], x_pre, vlm_cfg.norm_eps)
        x_suf = cm.rms_norm(expert_params["final_norm"], x_suf, expert_cfg.norm_eps)
        return x_pre, x_suf
    x_suf = joint_last_pair(
        cm.layer(vb, depth - 1), cm.layer(eb, depth - 1), x_pre, x_suf, mask[:, p_len:, :],
        pos_pre, pos_suf, vlm_cfg, expert_cfg, policy, tps,
    )
    return None, cm.rms_norm(expert_params["final_norm"], x_suf, expert_cfg.norm_eps)


def _remat_layer(body, carry, vb, eb, i: int):
    """Layer pair i, its weights gathered inside the checkpointed function, so
    the recomputed forward gathers them again and no whole layer outlives it."""
    def pair(xp, xs):
        return body((xp, xs), (cm.layer(vb, i), cm.layer(eb, i)))[0]

    if not torch.is_grad_enabled():
        return pair(*carry)
    return checkpoint(pair, *carry, use_reentrant=False)


def _joint_body(mask, pos_pre, pos_suf, vlm_cfg: GemmaConfig, expert_cfg: GemmaConfig,
                policy: DtypePolicy, attention_impl: str, tps=(None, None)):
    """One joint prefix+suffix layer pair, body(carry, (bp_v, bp_e)) ->
    (carry, None), shared by forward_joint and the fused training step's
    forward and per-layer recompute. tps: the two streams' tensor groups."""
    p_len = pos_pre.shape[1]
    scale = vlm_cfg.head_dim**-0.5
    tp_v, tp_e = tps

    def body(carry, bps):
        xp, xs = carry
        bp_v, bp_e = bps
        yp = cm.rms_norm(bp_v["ln1"], xp, vlm_cfg.norm_eps)
        ys = cm.rms_norm(bp_e["ln1"], xs, expert_cfg.norm_eps)
        qp, kp, vp = _qkv(bp_v, yp, pos_pre, vlm_cfg, policy, tp_v)
        qs, ks, vs = _qkv(bp_e, ys, pos_suf, expert_cfg, policy, tp_e)
        q = torch.cat([qp, qs], dim=1)
        k = torch.cat([kp, ks], dim=1)
        v = torch.cat([vp, vs], dim=1)
        att = multi_head_attention(q, k, v, mask=mask, impl=attention_impl, scale=scale)
        xp = _post_attention(bp_v, xp, att[:, :p_len], vlm_cfg, policy, tp_v)
        xs = _post_attention(bp_e, xs, att[:, p_len:], expert_cfg, policy, tp_e)
        return (xp, xs), None

    return body


def joint_last_pair(last_v, last_e, x_pre, x_suf, suffix_mask, pos_pre, pos_suf,
                    vlm_cfg: GemmaConfig, expert_cfg: GemmaConfig,
                    policy: DtypePolicy = DEFAULT_POLICY, tps=(None, None)):
    """The suffix_only last layer: the prefix side contributes only ln1 + K/V;
    the suffix side runs the full layer against [prefix K/V; suffix K/V].
    suffix_mask is mask[:, p_len:, :]. The attention is the plain path: the
    suffix has only 1 + chunk query rows. Over tensor the prefix K/V serve the
    suffix's local heads only, so the prefix's region input goes through
    `copy_in` as a column-parallel input would."""
    scale = vlm_cfg.head_dim**-0.5
    tp_v, tp_e = tps
    yp = cm.rms_norm(last_v["ln1"], x_pre, vlm_cfg.norm_eps)
    region_v = _attention_region(last_v, vlm_cfg, tp_v)
    kp, vp = _kv(last_v, tensor_parallel.copy_in(yp, region_v), pos_pre, vlm_cfg, policy, region_v)
    ys = cm.rms_norm(last_e["ln1"], x_suf, expert_cfg.norm_eps)
    qs, ks, vs = _qkv(last_e, ys, pos_suf, expert_cfg, policy, tp_e)
    k = torch.cat([kp, ks], dim=1)
    v = torch.cat([vp, vs], dim=1)
    att = multi_head_attention(qs, k, v, mask=suffix_mask, impl="xla", scale=scale)
    return _post_attention(last_e, x_suf, att, expert_cfg, policy, tp_e)


def prefill(
    vlm_params: cm.Params,
    x_pre: torch.Tensor,  # [B, P, D_vlm]
    mask: torch.Tensor,  # bool[B, P, P]
    positions: torch.Tensor,  # int[B, P]
    cfg: GemmaConfig,
    policy: DtypePolicy = DEFAULT_POLICY,
    attention_impl: str = "xla",
    kv_only: bool = False,
    cache_len: int | None = None,
):
    """Prefix-only pass; returns (prefix_out, kv_cache).

    kv_cache = (k, v) each [L, B, cache_len, KVH, head_dim] (cache_len P by
    default), K cached WITH RoPE applied, so decode never re-rotates prefix
    keys. Slots past the prefix are zeros, for a decoder that appends to the
    cache (Pi0FAST's greedy decode) and masks what it has not written.

    kv_only=True is for callers that consume only the cache (Pi0
    sample_actions): the last layer's attention output, out-projection, MLP
    and the final norm feed only prefix_out, so the pass runs depth-1 full
    layers and then only the last layer's ln1 + K/V projection (depth-1
    attention calls); returns (None, kv_cache).

    Under autograd (grad enabled and x_pre or a block weight requiring grad:
    Pi0FAST's training loss) the pass builds no cache, whose in-place writes
    no gradient reaches, runs each layer under `torch.utils.checkpoint`, so
    the backward recomputes one layer at a time, as the reference's per-layer
    remat does, and returns (prefix_out, None).
    """
    scale = cfg.head_dim**-0.5
    blocks = vlm_params["blocks"]
    tp = tensor_parallel.of(vlm_params)

    def layer(x, bp):
        y = cm.rms_norm(bp["ln1"], x, cfg.norm_eps)
        q, k, v = _qkv(bp, y, positions, cfg, policy, tp)
        att = multi_head_attention(q, k, v, mask=mask, impl=attention_impl, scale=scale)
        return _post_attention(bp, x, att, cfg, policy, tp), k, v

    if torch.is_grad_enabled() and (x_pre.requires_grad or any(w.requires_grad for w in cm.tree_leaves(blocks))):
        if kv_only or cache_len is not None:
            raise ValueError("prefill under autograd returns prefix_out and builds no cache")
        for i in range(cfg.depth):  # the layer's weights gathered inside, again in the recompute
            body = functools.partial(lambda x, i: layer(x, cm.layer(blocks, i))[0], i=i)
            x_pre = checkpoint(body, x_pre, use_reentrant=False)
        return cm.rms_norm(vlm_params["final_norm"], x_pre, cfg.norm_eps), None

    b, p_len, _ = x_pre.shape
    slots = p_len if cache_len is None else cache_len
    shape = (cfg.depth, b, slots, cfg.num_kv_heads, cfg.head_dim)
    cache_k = torch.empty(shape, dtype=policy.compute_dtype, device=x_pre.device)
    cache_v = torch.empty_like(cache_k)
    if slots > p_len:
        cache_k[:, :, p_len:].zero_()
        cache_v[:, :, p_len:].zero_()

    full_layers = cfg.depth - 1 if kv_only else cfg.depth
    for i in range(full_layers):
        x_pre, cache_k[i, :, :p_len], cache_v[i, :, :p_len] = layer(x_pre, cm.layer(blocks, i))

    if not kv_only:
        return cm.rms_norm(vlm_params["final_norm"], x_pre, cfg.norm_eps), (cache_k, cache_v)

    last = cm.layer(blocks, cfg.depth - 1)
    y = cm.rms_norm(last["ln1"], x_pre, cfg.norm_eps)
    cache_k[-1, :, :p_len], cache_v[-1, :, :p_len] = _kv(last, y, positions, cfg, policy,
                                                         _attention_region(last, cfg, tp))
    return None, (cache_k, cache_v)


def decode(
    expert_params: cm.Params,
    kv_cache,  # (k, v) from prefill: [L, B, P, KVH, head_dim]
    x_suf: torch.Tensor,  # [B, S, D_exp]
    mask: torch.Tensor,  # bool[B, S, P+S]
    positions: torch.Tensor,  # int[B, S] (continuing after the prefix)
    cfg: GemmaConfig,
    policy: DtypePolicy = DEFAULT_POLICY,
    attention_impl: str = "xla",
) -> torch.Tensor:
    """Suffix pass against a frozen prefix cache. Returns final-normed suffix.

    The attention scale is the EXPERT's head_dim**-0.5. The attention is the
    split-cache form: the prefix K/V stay where prefill wrote them.
    `attention_impl` is accepted for signature parity; the suffix's few query
    rows always take the plain path, as in the reference. Over tensor the
    rank's heads enter that plain attention among zero ones, at one card's
    shapes (`tensor_parallel.whole_groups`: Pi0's one K/V head's group is
    all 8 heads), so each rank does one card's decode attention, t times its
    share of it.
    """
    cache_k, cache_v = kv_cache
    scale = cfg.head_dim**-0.5
    p_len = cache_k.shape[2]
    mask_cache, mask_new = mask[:, :, :p_len], mask[:, :, p_len:]
    tp = tensor_parallel.of(expert_params)

    for i in range(cfg.depth):
        bp = cm.layer(expert_params["blocks"], i)
        y = cm.rms_norm(bp["ln1"], x_suf, cfg.norm_eps)
        q, k, v = _qkv(bp, y, positions, cfg, policy, tp)
        # this rank's heads at their places among zero ones
        q, own = tensor_parallel.whole_groups(q, _attention_region(bp, cfg, tp), cfg.num_heads, cfg.num_kv_heads)
        att = xla_attention_cached(
            q, cache_k[i].to(k.dtype), cache_v[i].to(v.dtype), k, v,
            mask_cache, mask_new, scale=scale,
        )
        x_suf = _post_attention(bp, x_suf, att[:, :, own], cfg, policy, tp)
    return cm.rms_norm(expert_params["final_norm"], x_suf, cfg.norm_eps)
