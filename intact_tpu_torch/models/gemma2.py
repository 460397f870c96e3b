"""Gemma2 decoder (PaliGemma2 / SpatialVLA-4B language trunk) and its
KV-cached greedy decode (intact_tpu/models/gemma2.py).

Gemma2 conventions, as in the reference:
  * four RMSNorms per layer: pre/post attention and pre/post feed-forward
    (the post-norms normalize the residual branch before the add);
  * attention logit softcapping cap * tanh(logits / cap) (cap 50) before the
    mask; the tied output logits capped at 30;
  * query scale query_pre_attn_scalar**-0.5 (not head_dim**-0.5 in general);
  * a sliding window on the even layers, global attention on the odd ones;
  * RMSNorm (1 + w) and the sqrt(width) scale of token embeddings.

The attention is the plain path: the softcap keeps it off the flash kernel,
as in the reference. Parameters are stacked [L, ...] under "blocks"; a
quantized tree (`cm.quantize_params`) sends every block product through the
W8A8 kernel and the tied unembedding through `cm.unembed_logits`.
"""

from __future__ import annotations

import dataclasses

import torch

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models.common import DEFAULT_POLICY, DtypePolicy
from intact_tpu_torch.ops.attention import BIG_NEG
from intact_tpu_torch.ops.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class Gemma2Config:
    width: int
    depth: int
    mlp_dim: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    vocab_size: int
    query_pre_attn_scalar: float = 256.0
    attn_logit_softcap: float = 50.0
    final_logit_softcap: float = 30.0
    sliding_window: int = 4096
    rope_base: float = 10_000.0
    norm_eps: float = 1e-6


def gemma2_2b() -> Gemma2Config:
    """PaliGemma2-3B's text trunk (the SpatialVLA-4B operating point)."""
    return Gemma2Config(width=2304, depth=26, mlp_dim=9216, num_heads=8, num_kv_heads=4, head_dim=256,
                        vocab_size=257_152)


def tiny_test_config() -> Gemma2Config:
    return Gemma2Config(width=32, depth=2, mlp_dim=64, num_heads=4, num_kv_heads=2, head_dim=8, vocab_size=99,
                        query_pre_attn_scalar=8.0, sliding_window=3)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(init: cm.Initializer, cfg: Gemma2Config) -> cm.Params:
    d, m, lead = cfg.width, cfg.mlp_dim, (cfg.depth,)
    qdim, kvdim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return {
        "embed": cm.embed_init(init, cfg.vocab_size, d),
        "blocks": {
            "ln1": cm.rmsnorm_init(init, d, lead),
            "attn": {
                "q": cm.dense_init(init, d, qdim, use_bias=False, lead=lead),
                "k": cm.dense_init(init, d, kvdim, use_bias=False, lead=lead),
                "v": cm.dense_init(init, d, kvdim, use_bias=False, lead=lead),
                "o": cm.dense_init(init, qdim, d, use_bias=False, lead=lead),
            },
            "post_attn_norm": cm.rmsnorm_init(init, d, lead),
            "pre_ffw_norm": cm.rmsnorm_init(init, d, lead),
            "mlp": {
                "gate": cm.dense_init(init, d, m, use_bias=False, lead=lead),
                "up": cm.dense_init(init, d, m, use_bias=False, lead=lead),
                "down": cm.dense_init(init, m, d, use_bias=False, lead=lead),
            },
            "post_ffw_norm": cm.rmsnorm_init(init, d, lead),
        },
        "final_norm": cm.rmsnorm_init(init, d),
    }


def init(cfg: Gemma2Config, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    return init_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _softcap_attention(q, k, v, mask, scale: float, cap: float) -> torch.Tensor:
    """Grouped-query attention with logit softcapping: q [B, T, H, hd], k and
    v [B, S, KVH, hd], mask bool [B, T, S]. fp32 logits and softmax; K/V are
    not repeated over the query groups."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    qg = (q * scale).reshape(b, t, kvh, h // kvh, d)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    logits = cap * torch.tanh(logits / cap)
    logits = torch.where(mask[:, None, None, :, :], logits, BIG_NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
    return out.reshape(b, t, h, d)


def _sliding_mask(positions_q: torch.Tensor, positions_k: torch.Tensor, window: int) -> torch.Tensor:
    """bool [B, T, S]: |q - k| < window. Symmetric: causality comes from the
    caller's mask, so a bidirectional prefix keeps sliding layers
    bidirectional."""
    delta = positions_q[:, :, None] - positions_k[:, None, :]
    return delta.abs() < window


def _qkv(bp, x, positions, cfg: Gemma2Config, policy: DtypePolicy):
    b, t, _ = x.shape
    y = cm.rms_norm(bp["ln1"], x, cfg.norm_eps)
    q = cm.dense(bp["attn"]["q"], y, policy).reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = cm.dense(bp["attn"]["k"], y, policy).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = cm.dense(bp["attn"]["v"], y, policy).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    return apply_rope(q, positions, cfg.rope_base), apply_rope(k, positions, cfg.rope_base), v


def _post_attention(bp, x, att, cfg: Gemma2Config, policy: DtypePolicy) -> torch.Tensor:
    b, t = att.shape[:2]
    x = x + cm.rms_norm(bp["post_attn_norm"], cm.dense(bp["attn"]["o"], att.reshape(b, t, -1), policy),
                        cfg.norm_eps)
    y = cm.rms_norm(bp["pre_ffw_norm"], x, cfg.norm_eps)
    return x + cm.rms_norm(bp["post_ffw_norm"], cm.gemma_mlp(bp["mlp"], y, policy), cfg.norm_eps)


def forward(
    params: cm.Params,
    embeds: torch.Tensor,  # [B, T, D] (text already sqrt(width)-scaled)
    mask: torch.Tensor,  # bool [B, T, T]
    positions: torch.Tensor,  # int [B, T]
    cfg: Gemma2Config,
    policy: DtypePolicy = DEFAULT_POLICY,
    use_sliding: bool = True,
    cache_len: int | None = None,
):
    """-> (final-normed hidden [B, T, D], (k, v) cache [L, B, cache_len, KVH,
    hd] with the K rotated; cache_len T by default, zeros past T).

    Even layers add the sliding window to `mask`, odd layers attend as the
    mask says. use_sliding=False drops the window on every layer: the
    PaliGemma2 prefix-LM convention for the bidirectional image+prompt
    prefix (generated tokens still get the window, in `greedy_decode`)."""
    scale = cfg.query_pre_attn_scalar**-0.5
    sliding = mask & _sliding_mask(positions, positions, cfg.sliding_window)
    b, t, _ = embeds.shape
    slots = t if cache_len is None else cache_len
    shape = (cfg.depth, b, slots, cfg.num_kv_heads, cfg.head_dim)
    cache_k = torch.empty(shape, dtype=policy.compute_dtype, device=embeds.device)
    cache_v = torch.empty_like(cache_k)
    if slots > t:
        cache_k[:, :, t:].zero_()
        cache_v[:, :, t:].zero_()
    x = embeds
    for i in range(cfg.depth):
        bp = cm.layer(params["blocks"], i)
        q, k, v = _qkv(bp, x, positions, cfg, policy)
        cache_k[i, :, :t], cache_v[i, :, :t] = k, v
        att = _softcap_attention(q, k, v, sliding if use_sliding and i % 2 == 0 else mask, scale,
                                 cfg.attn_logit_softcap)
        x = _post_attention(bp, x, att, cfg, policy)
    return cm.rms_norm(params["final_norm"], x, cfg.norm_eps), (cache_k, cache_v)


def logits(params: cm.Params, hidden: torch.Tensor, cfg: Gemma2Config,
           policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Tied-embedding head with the final softcap -> fp32 [..., V]. A
    quantized table streams int8 through the W8A8 kernel."""
    out = cm.unembed_logits(params["embed"], hidden, policy)
    cap = cfg.final_logit_softcap
    return cap * torch.tanh(out / cap)


def embed_tokens(params: cm.Params, tokens: torch.Tensor, cfg: Gemma2Config,
                 policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Token ids -> embeddings times sqrt(width), in the compute dtype."""
    x = cm.embed_lookup(params["embed"], tokens, policy)
    return x * torch.tensor(cfg.width**0.5, dtype=x.dtype, device=x.device)


def encode_text(params, tokens, mask2d, positions, cfg: Gemma2Config, policy: DtypePolicy = DEFAULT_POLICY):
    """Token ids -> final-normed hidden."""
    return forward(params, embed_tokens(params, tokens, cfg, policy), mask2d, positions, cfg, policy)[0]


def prefill(params, prompt_embeds, prompt_mask, max_new_tokens: int, cfg: Gemma2Config,
            policy: DtypePolicy = DEFAULT_POLICY, prefix_full_attention: bool = False):
    """The prompt through the trunk into a cache with room for the decode ->
    (last hidden [B, D], cache, key_valid [B, slots], key_pos [B, slots],
    next position [B]). Positions are cumsum(mask) - 1; the last hidden is
    the one at the last valid prompt token."""
    b, p_len, _ = prompt_embeds.shape
    positions = torch.cumsum(prompt_mask.to(torch.int32), dim=1) - 1
    if prefix_full_attention:
        causal = torch.ones((1, p_len, p_len), dtype=torch.bool, device=prompt_embeds.device)
    else:
        causal = torch.tril(torch.ones((p_len, p_len), dtype=torch.bool, device=prompt_embeds.device))[None]
    mask = causal & prompt_mask[:, None, :]
    # the last generated token is never fed back: max_new_tokens - 1 decode slots
    slots = p_len + max(max_new_tokens - 1, 0)
    hidden, cache = forward(params, prompt_embeds, mask, positions, cfg, policy,
                            use_sliding=not prefix_full_attention, cache_len=slots)
    key_valid = torch.zeros((b, slots), dtype=torch.bool, device=prompt_embeds.device)
    key_valid[:, :p_len] = prompt_mask
    key_pos = torch.zeros((b, slots), dtype=positions.dtype, device=prompt_embeds.device)
    key_pos[:, :p_len] = positions
    rows = torch.arange(b, device=prompt_embeds.device)
    last_idx = prompt_mask.to(torch.int32).sum(dim=1) - 1
    return hidden[rows, last_idx], cache, key_valid, key_pos, positions[rows, last_idx] + 1


def decode_step(params, token, cache, slot: int, key_valid, key_pos, pos, cfg: Gemma2Config,
                policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Feed token [B] at position pos [B] into cache slot `slot` through every
    layer (key_valid and key_pos are updated in place) -> final-normed hidden
    [B, D]. Even layers see the keys within the sliding window behind pos,
    odd layers every valid key at or behind it."""
    ck, cv = cache
    scale = cfg.query_pre_attn_scalar**-0.5
    x = embed_tokens(params, token[:, None], cfg, policy)
    key_valid[:, slot] = True
    key_pos[:, slot] = pos
    delta = pos[:, None] - key_pos
    global_m = key_valid & (delta >= 0)
    in_window = global_m & (delta < cfg.sliding_window)
    for i in range(cfg.depth):
        bp = cm.layer(params["blocks"], i)
        q, k, v = _qkv(bp, x, pos[:, None], cfg, policy)
        ck[i, :, slot], cv[i, :, slot] = k[:, 0], v[:, 0]
        m = (in_window if i % 2 == 0 else global_m)[:, None, :]
        x = _post_attention(bp, x, _softcap_attention(q, ck[i], cv[i], m, scale, cfg.attn_logit_softcap), cfg,
                            policy)
    return cm.rms_norm(params["final_norm"], x, cfg.norm_eps)[:, 0]


@torch.inference_mode()
def greedy_decode(
    params: cm.Params,
    prompt_embeds: torch.Tensor,  # [B, P, D] (multimodal embeds, pre-scaled)
    prompt_mask: torch.Tensor,  # bool [B, P]
    max_new_tokens: int,
    cfg: Gemma2Config,
    policy: DtypePolicy = DEFAULT_POLICY,
    prefix_full_attention: bool = False,
) -> torch.Tensor:
    """KV-cached greedy decode -> [B, max_new_tokens] token ids (int64).

    The prompt is prefilled once; token s + 1 comes from feeding token s into
    cache slot P + s at the next position. The argmax takes the first index
    of the softcapped fp32 logits' maximum, as jnp.argmax does. The
    reference's decode loop also feeds the last token through the trunk and
    discards the result; that step is not run here (the tokens are the same).
    prefix_full_attention=True makes the prompt bidirectional (the
    PaliGemma2 prefix-LM convention)."""
    last, cache, key_valid, key_pos, pos = prefill(params, prompt_embeds, prompt_mask, max_new_tokens, cfg, policy,
                                                   prefix_full_attention)
    p_len = prompt_embeds.shape[1]
    tokens = [logits(params, last, cfg, policy).argmax(dim=-1)]
    for s in range(max_new_tokens - 1):
        h = decode_step(params, tokens[-1], cache, p_len + s, key_valid, key_pos, pos + s, cfg, policy)
        tokens.append(logits(params, h, cfg, policy).argmax(dim=-1))
    return torch.stack(tokens, dim=1)


# ---------------------------------------------------------------------------
# HF checkpoint -> params
# ---------------------------------------------------------------------------

def from_hf_state_dict(sd: dict, cfg: Gemma2Config, prefix: str = "model") -> cm.Params:
    """transformers Gemma2Model naming -> host parameter tree (CPU tensors):
    Linear weights [out, in] transposed to kernels [in, out], layers
    stacked."""
    from intact_tpu_torch.models.hf_import import stack, t, tensor

    prefix = prefix + "." if prefix else ""
    f = prefix + "layers.{i}."

    def lin(name):
        return {"kernel": stack(sd, f + name + ".weight", cfg.depth, t)}

    def norm(name):
        return {"scale": stack(sd, f + name + ".weight", cfg.depth)}

    return {
        "embed": {"embedding": tensor(sd[prefix + "embed_tokens.weight"])},
        "blocks": {
            "ln1": norm("input_layernorm"),
            "attn": {k: lin(f"self_attn.{k}_proj") for k in ("q", "k", "v", "o")},
            "post_attn_norm": norm("post_attention_layernorm"),
            "pre_ffw_norm": norm("pre_feedforward_layernorm"),
            "mlp": {k: lin(f"mlp.{k}_proj") for k in ("gate", "up", "down")},
            "post_ffw_norm": norm("post_feedforward_layernorm"),
        },
        "final_norm": {"scale": tensor(sd[prefix + "norm.weight"])},
    }
