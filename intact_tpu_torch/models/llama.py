"""LLaMA-3-family decoder (Magma-8B's language trunk) and its KV-cached
greedy decode (intact_tpu/models/llama.py).

Conventions, as in the reference (transformers LlamaModel):
  * RMSNorm x * rsqrt(mean(x^2) + eps) * w (plain w, unlike Gemma's 1 + w);
  * rotary embedding, half-split rotation, theta 500,000 at LLaMA-3;
  * grouped-query attention (32 query heads over 8 KV heads at 8B), scale
    1/sqrt(head_dim), on the plain path (`multi_head_attention`'s default,
    as in the reference);
  * SiLU-gated MLP (gate, up, down); no embedding scale;
  * an untied `lm_head` [width, vocab] unless tie_embeddings.

Parameters are stacked [L, ...] under "blocks". A quantized tree
(`cm.quantize_params`) sends every block product and the untied `lm_head`
through the W8A8 kernel (`cm.dense`); the int8 `lm/embed` rows are only
gathered (`cm.embed_lookup`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models.common import DEFAULT_POLICY, DtypePolicy
from intact_tpu_torch.ops.attention import multi_head_attention
from intact_tpu_torch.ops.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    width: int
    depth: int
    mlp_dim: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    vocab_size: int
    rope_base: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False


def llama3_8b() -> LlamaConfig:
    return LlamaConfig(width=4096, depth=32, mlp_dim=14_336, num_heads=32, num_kv_heads=8, head_dim=128,
                       vocab_size=128_256)


def tiny_test_config() -> LlamaConfig:
    return LlamaConfig(width=32, depth=2, mlp_dim=64, num_heads=4, num_kv_heads=2, head_dim=8, vocab_size=99,
                       rope_base=10_000.0)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(init: cm.Initializer, cfg: LlamaConfig) -> cm.Params:
    d, m, lead = cfg.width, cfg.mlp_dim, (cfg.depth,)
    qdim, kvdim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    params = {
        "embed": cm.embed_init(init, cfg.vocab_size, d),
        "blocks": {
            "ln1": {"scale": init.ones((cfg.depth, d))},
            "attn": {
                "q": cm.dense_init(init, d, qdim, use_bias=False, lead=lead),
                "k": cm.dense_init(init, d, kvdim, use_bias=False, lead=lead),
                "v": cm.dense_init(init, d, kvdim, use_bias=False, lead=lead),
                "o": cm.dense_init(init, qdim, d, use_bias=False, lead=lead),
            },
            "ln2": {"scale": init.ones((cfg.depth, d))},
            "mlp": {
                "gate": cm.dense_init(init, d, m, use_bias=False, lead=lead),
                "up": cm.dense_init(init, d, m, use_bias=False, lead=lead),
                "down": cm.dense_init(init, m, d, use_bias=False, lead=lead),
            },
        },
        "final_norm": {"scale": init.ones((d,))},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.dense_init(init, d, cfg.vocab_size, use_bias=False)
    return params


def init(cfg: LlamaConfig, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    return init_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


def llama_rms_norm(p: cm.Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics, plain scale gain, cast back."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _qkv(bp, x, positions, cfg: LlamaConfig, policy: DtypePolicy):
    b, t, _ = x.shape
    q = cm.dense(bp["attn"]["q"], x, policy).reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = cm.dense(bp["attn"]["k"], x, policy).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = cm.dense(bp["attn"]["v"], x, policy).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    return apply_rope(q, positions, cfg.rope_base), apply_rope(k, positions, cfg.rope_base), v


def _silu_mlp(bp, x, policy: DtypePolicy) -> torch.Tensor:
    gate = F.silu(cm.dense(bp["mlp"]["gate"], x, policy))
    return cm.dense(bp["mlp"]["down"], gate * cm.dense(bp["mlp"]["up"], x, policy), policy)


def _block_out(bp, x, att, cfg: LlamaConfig, policy: DtypePolicy) -> torch.Tensor:
    b, t = att.shape[:2]
    x = x + cm.dense(bp["attn"]["o"], att.reshape(b, t, -1), policy)
    return x + _silu_mlp(bp, llama_rms_norm(bp["ln2"], x, cfg.norm_eps), policy)


def forward(
    params: cm.Params,
    embeds: torch.Tensor,  # [B, T, D] (inputs_embeds: the multimodal splice)
    mask: torch.Tensor,  # bool [B, T, T]
    positions: torch.Tensor,  # int [B, T]
    cfg: LlamaConfig,
    policy: DtypePolicy = DEFAULT_POLICY,
    cache_len: int | None = None,
):
    """-> (final-normed hidden [B, T, D], (k, v) cache [L, B, cache_len, KVH,
    hd] with the K rotated; cache_len T by default, zeros past T)."""
    scale = cfg.head_dim**-0.5
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
        q, k, v = _qkv(bp, llama_rms_norm(bp["ln1"], x, cfg.norm_eps), positions, cfg, policy)
        cache_k[i, :, :t], cache_v[i, :, :t] = k, v
        x = _block_out(bp, x, multi_head_attention(q, k, v, mask=mask, scale=scale), cfg, policy)
    return llama_rms_norm(params["final_norm"], x, cfg.norm_eps), (cache_k, cache_v)


def logits(params: cm.Params, hidden: torch.Tensor, cfg: LlamaConfig,
           policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """-> fp32 [..., V]: the untied `lm_head` through `cm.dense` (the W8A8
    kernel when quantized; its compute-dtype output cast to fp32 after the
    product, as in the reference), else the tied table."""
    if cfg.tie_embeddings or "lm_head" not in params:
        return cm.unembed_logits(params["embed"], hidden, policy)
    return cm.dense(params["lm_head"], hidden, policy).to(torch.float32)


def prefill(params, prompt_embeds, prompt_mask, max_new_tokens: int, cfg: LlamaConfig,
            policy: DtypePolicy = DEFAULT_POLICY):
    """The right-padded prompt through the trunk (causal), into a cache with
    room for the decode -> (last hidden [B, D], cache, key_valid [B, slots],
    next position [B]). Positions are cumsum(mask) - 1; the last hidden is
    the one at the last valid prompt token."""
    b, p_len, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    positions = torch.cumsum(prompt_mask.to(torch.int32), dim=1) - 1
    mask = torch.tril(torch.ones((p_len, p_len), dtype=torch.bool, device=dev))[None] & prompt_mask[:, None, :]
    # the last generated token is never fed back: max_new_tokens - 1 decode slots
    slots = p_len + max(max_new_tokens - 1, 0)
    hidden, cache = forward(params, prompt_embeds, mask, positions, cfg, policy, cache_len=slots)
    key_valid = torch.zeros((b, slots), dtype=torch.bool, device=dev)
    key_valid[:, :p_len] = prompt_mask
    rows = torch.arange(b, device=dev)
    last_idx = prompt_mask.to(torch.int32).sum(dim=1) - 1
    return hidden[rows, last_idx], cache, key_valid, positions[rows, last_idx] + 1


def decode_step(params, token, cache, slot: int, key_valid, pos, cfg: LlamaConfig,
                policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Feed token [B] at position pos [B] into cache slot `slot` through
    every layer (key_valid is updated in place) -> final-normed hidden [B,
    D]. The token attends to every valid key of the cache."""
    ck, cv = cache
    scale = cfg.head_dim**-0.5
    x = cm.embed_lookup(params["embed"], token[:, None], policy)
    key_valid[:, slot] = True
    mask = key_valid[:, None, :]
    for i in range(cfg.depth):
        bp = cm.layer(params["blocks"], i)
        q, k, v = _qkv(bp, llama_rms_norm(bp["ln1"], x, cfg.norm_eps), pos[:, None], cfg, policy)
        ck[i, :, slot], cv[i, :, slot] = k[:, 0], v[:, 0]
        x = _block_out(bp, x, multi_head_attention(q, ck[i], cv[i], mask=mask, scale=scale), cfg, policy)
    return llama_rms_norm(params["final_norm"], x, cfg.norm_eps)[:, 0]


@torch.inference_mode()
def greedy_decode(
    params: cm.Params,
    prompt_embeds: torch.Tensor,  # [B, P, D]
    prompt_mask: torch.Tensor,  # bool [B, P]
    max_new_tokens: int,
    cfg: LlamaConfig,
    policy: DtypePolicy = DEFAULT_POLICY,
) -> torch.Tensor:
    """KV-cached greedy decode -> [B, max_new_tokens] token ids (int64).

    Token s + 1 comes from feeding token s into cache slot P + s at position
    last valid + 1 + s. The argmax takes the first index of the fp32
    logits' maximum, as jnp.argmax does. The reference's scan also feeds the
    last token through the trunk and discards the result; that step is not
    run here (the tokens are the same)."""
    last, cache, key_valid, pos = prefill(params, prompt_embeds, prompt_mask, max_new_tokens, cfg, policy)
    p_len = prompt_embeds.shape[1]
    tokens = [logits(params, last, cfg, policy).argmax(dim=-1)]
    for s in range(max_new_tokens - 1):
        h = decode_step(params, tokens[-1], cache, p_len + s, key_valid, pos + s, cfg, policy)
        tokens.append(logits(params, h, cfg, policy).argmax(dim=-1))
    return torch.stack(tokens, dim=1)


# ---------------------------------------------------------------------------
# HF checkpoint -> params
# ---------------------------------------------------------------------------

def from_hf_state_dict(sd: dict, cfg: LlamaConfig, prefix: str = "model",
                       head_key: str = "lm_head.weight") -> cm.Params:
    """Flat state dict in LlamaForCausalLM naming (or Magma's language_model)
    -> host parameter tree (CPU tensors): Linear weights [out, in] transposed
    to kernels [in, out], layers stacked. `head_key` locates the untied head
    in a multimodal checkpoint (e.g. `language_model.lm_head.weight`)."""
    from intact_tpu_torch.models.hf_import import stack, t, tensor

    f = prefix + ".layers.{i}."

    def lin(name):
        return {"kernel": stack(sd, f + name + ".weight", cfg.depth, t)}

    params = {
        "embed": {"embedding": tensor(sd[prefix + ".embed_tokens.weight"])},
        "blocks": {
            "ln1": {"scale": stack(sd, f + "input_layernorm.weight", cfg.depth)},
            "attn": {k: lin(f"self_attn.{k}_proj") for k in ("q", "k", "v", "o")},
            "ln2": {"scale": stack(sd, f + "post_attention_layernorm.weight", cfg.depth)},
            "mlp": {k: lin(f"mlp.{k}_proj") for k in ("gate", "up", "down")},
        },
        "final_norm": {"scale": tensor(sd[prefix + ".norm.weight"])},
    }
    if head_key in sd:
        params["lm_head"] = {"kernel": t(sd[head_key])}
    return params
