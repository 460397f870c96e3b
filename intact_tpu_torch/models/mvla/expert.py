"""MVLA action expert: alternating self-/cross-attention Gemma layers, or
joint attention over [prompt | suffix] (intact_tpu/models/mvla/expert.py).

"self_cross": even layers self-attend over the suffix (state + noisy action
tokens, the block mask, RoPE) through `multi_head_attention(impl=...)`, which
reaches the attention kernel for "pallas"; odd layers cross-attend with Q from
the suffix and K/V from the connector's prompt, with no RoPE and no mask, on
the plain path. The prompt K/V are computed once per sampling call
(`prefill_prompt_kv`) and reused by every Euler step. Parameters are stacked
per self/cross pair under "pairs/self" and "pairs/cross", [depth/2, ...];
the depth must be even.

"joint" (mmmvla): plain Gemma blocks; the prompt forms attention block 0,
which the suffix attends into. Sampling caches the prompt's K/V once with
`gemma.prefill(kv_only=True)` and runs only the suffix per step through
`gemma.decode`; without a cache one prefill runs over [prompt | suffix].

Over tensor ranks (Megatron-style, parallel/tensor.py) each layer runs the
rank's query heads, as Gemma's do (models/gemma.py): the self layer's q, gate
and up column-, o and down row-parallel, its one K/V head whole; the cross
layer's q column- and o row-parallel, its one K/V head of the prompt
computed whole on every rank (the prompt through `copy_in`: each rank's
gradient of it is its heads' part). The cross attention, on the plain path,
takes the rank's heads among zero ones at one card's shapes
(`tensor_parallel.whole_groups`), as `gemma.decode` does. The joint pattern
runs `gemma.prefill` and `gemma.decode`, which take the tensor axis
themselves. Each entry point finds its tensor group in its parameters.
"""

from __future__ import annotations

import torch

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models import gemma
from intact_tpu_torch.models.common import DEFAULT_POLICY, DtypePolicy
from intact_tpu_torch.models.gemma import GemmaConfig, _attention_region, _post_attention, _qkv
from intact_tpu_torch.ops.attention import multi_head_attention
from intact_tpu_torch.ops.masks import make_att_2d_masks
from intact_tpu_torch.parallel import tensor as tensor_parallel


def _cross_block_params(init: cm.Initializer, cfg: GemmaConfig, prompt_dim: int, lead: tuple) -> cm.Params:
    d, m = cfg.width, cfg.mlp_dim
    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim
    return {
        "ln1": cm.rmsnorm_init(init, d, lead),
        "attn": {
            "q": cm.dense_init(init, d, qdim, use_bias=False, lead=lead),
            "k": cm.dense_init(init, prompt_dim, kvdim, use_bias=False, lead=lead),
            "v": cm.dense_init(init, prompt_dim, kvdim, use_bias=False, lead=lead),
            "o": cm.dense_init(init, qdim, d, use_bias=False, lead=lead),
        },
        "ln2": cm.rmsnorm_init(init, d, lead),
        "mlp": {
            "gate": cm.dense_init(init, d, m, use_bias=False, lead=lead),
            "up": cm.dense_init(init, d, m, use_bias=False, lead=lead),
            "down": cm.dense_init(init, m, d, use_bias=False, lead=lead),
        },
    }


def init_params(init: cm.Initializer, cfg: GemmaConfig, prompt_dim: int) -> cm.Params:
    if cfg.depth % 2:
        raise ValueError("self_cross expert needs an even layer count")
    lead = (cfg.depth // 2,)
    return {
        "pairs": {
            "self": gemma.init_block_params(init, cfg, lead),
            "cross": _cross_block_params(init, cfg, prompt_dim, lead),
        },
        "final_norm": cm.rmsnorm_init(init, cfg.width),
    }


def prefill_prompt_kv(params: cm.Params, prompt: torch.Tensor, cfg: GemmaConfig,
                      policy: DtypePolicy = DEFAULT_POLICY):
    """Prompt embeddings [B, P, prompt_dim] -> the cross layers' K/V, each
    [L/2, B, P, KVH, head_dim], one layer at a time."""
    cross = params["pairs"]["cross"]["attn"]
    kv = [_prompt_kv(cm.layer({"k": cross["k"], "v": cross["v"]}, i), prompt, cfg, policy)
          for i in range(cfg.depth // 2)]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


def _prompt_kv(attn: cm.Params, prompt: torch.Tensor, cfg: GemmaConfig, policy: DtypePolicy):
    """One cross layer's K/V of the prompt (its "k" and "v" nodes whole)."""
    b, p_len, _ = prompt.shape
    x = policy.cast(prompt)
    shape = (b, p_len, cfg.num_kv_heads, cfg.head_dim)
    return cm.dense(attn["k"], x, policy).reshape(shape), cm.dense(attn["v"], x, policy).reshape(shape)


def forward(
    params: cm.Params,
    suffix: torch.Tensor,  # [B, S, D]
    suffix_mask: torch.Tensor,  # bool [B, S, S]
    positions: torch.Tensor,  # int [B, S]
    cfg: GemmaConfig,
    prompt: torch.Tensor | None = None,  # [B, P, prompt_dim]
    prompt_kv=None,  # (k, v) from prefill_prompt_kv
    policy: DtypePolicy = DEFAULT_POLICY,
    attention_impl: str = "xla",
) -> torch.Tensor:
    """The alternating expert -> final-normed suffix [B, S, D]; exactly one
    of prompt / prompt_kv is given. Given the prompt, each cross layer's K/V
    come from the layer as gathered for its pass (one gather per layer over
    fsdp ranks)."""
    b, s, _ = suffix.shape
    scale = cfg.head_dim**-0.5
    tp = tensor_parallel.of(params["pairs"])
    x = suffix
    for i in range(cfg.depth // 2):
        bp_self, bp_cross = cm.layer(params["pairs"]["self"], i), cm.layer(params["pairs"]["cross"], i)
        tpc = _attention_region(bp_cross, cfg, tp)
        ki, vi = (prompt_kv[0][i], prompt_kv[1][i]) if prompt_kv is not None else _prompt_kv(
            bp_cross["attn"], tensor_parallel.copy_in(prompt, tpc), cfg, policy)
        # self attention over the suffix (block mask + rope), the rank's heads
        y = cm.rms_norm(bp_self["ln1"], x, cfg.norm_eps)
        q, k, v = _qkv(bp_self, y, positions, cfg, policy, tp)
        att = multi_head_attention(q, k, v, mask=suffix_mask, impl=attention_impl, scale=scale)
        x = _post_attention(bp_self, x, att, cfg, policy, tp)
        # cross attention into the prompt (no rope, full attention, plain path), the rank's heads among zero ones
        y = tensor_parallel.copy_in(cm.rms_norm(bp_cross["ln1"], x, cfg.norm_eps), tpc)
        q = cm.dense_column(bp_cross["attn"]["q"], y, policy, tpc).reshape(b, s, -1, cfg.head_dim)
        q, own = tensor_parallel.whole_groups(q, tpc, cfg.num_heads, cfg.num_kv_heads)
        att = multi_head_attention(q, ki.to(q.dtype), vi.to(q.dtype), mask=None, scale=scale)
        x = _post_attention(bp_cross, x, att[:, :, own], cfg, policy, tp)
    return cm.rms_norm(params["final_norm"], x, cfg.norm_eps)


def prefill_joint_prompt_kv(params: cm.Params, prompt: torch.Tensor, cfg: GemmaConfig,
                            policy: DtypePolicy = DEFAULT_POLICY, attention_impl: str = "xla"):
    """The joint pattern's prompt K/V, computed once per inference: the
    prompt is attention block 0 and never attends the suffix, so its K/V do
    not depend on the suffix. -> (k, v) each [L, B, P, KVH, head_dim]."""
    b, p_len, _ = prompt.shape
    pad = torch.ones((b, p_len), dtype=torch.bool, device=prompt.device)
    mask = make_att_2d_masks(pad, torch.zeros((b, p_len), dtype=torch.int32, device=prompt.device))
    pos = torch.arange(p_len, device=prompt.device)[None].expand(b, p_len)
    _, kv = gemma.prefill(params, policy.cast(prompt), mask, pos, cfg, policy, attention_impl, kv_only=True)
    return kv


def forward_joint(
    params: cm.Params,
    suffix: torch.Tensor,  # [B, S, D]
    prompt: torch.Tensor,  # [B, P, D] (the expert's width)
    suffix_att: torch.Tensor,  # int [B, S] block starts
    cfg: GemmaConfig,
    policy: DtypePolicy = DEFAULT_POLICY,
    attention_impl: str = "xla",
    prompt_kv=None,
) -> torch.Tensor:
    """Joint pattern -> final-normed suffix [B, S, D]. With prompt_kv (from
    prefill_joint_prompt_kv) only the suffix runs, through `gemma.decode` at
    positions P + i; without it one prefill runs over [prompt | suffix]. The
    two agree: the cache holds the prompt keys rotated at the same positions."""
    b, p_len, _ = prompt.shape
    s_len = suffix.shape[1]
    dev = suffix.device
    if prompt_kv is not None:
        suf_self = make_att_2d_masks(torch.ones((b, s_len), dtype=torch.bool, device=dev), suffix_att)
        mask = torch.cat([torch.ones((b, s_len, p_len), dtype=torch.bool, device=dev), suf_self], dim=2)
        pos = (p_len + torch.arange(s_len, device=dev))[None].expand(b, s_len)
        return gemma.decode(params, prompt_kv, suffix, mask, pos, cfg, policy, attention_impl)

    x = torch.cat([policy.cast(prompt), suffix], dim=1)
    pad = torch.ones((b, p_len + s_len), dtype=torch.bool, device=dev)
    att = torch.cat([torch.zeros((b, p_len), dtype=torch.int32, device=dev), suffix_att.to(torch.int32)], dim=1)
    pos = torch.arange(p_len + s_len, device=dev)[None].expand(b, p_len + s_len)
    out, _ = gemma.prefill(params, x, make_att_2d_masks(pad, att), pos, cfg, policy, attention_impl)
    return out[:, p_len:]
