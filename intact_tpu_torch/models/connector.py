"""Bidirectional transformer connector (intact_tpu/models/connector.py).

A non-causal encoder with RMSNorm, per-head QK RMSNorm, a gated MLP and
optional RoPE that maps the VLM's metaquery outputs into the action expert's
prompt space. Layers are stacked [L, ...] and run one at a time. Its
attention is the plain path (no mask), as in the reference.

Over tensor ranks (Megatron-style, parallel/tensor.py): where the heads
split, q, k and v are column-parallel, the per-head q/k norms act on the
rank's heads (their scales replicated, each rank's gradient its heads'
part), the attention runs the rank's heads (multi-head: they fill whole
groups) and o is row-parallel; gate and up column-, down row-parallel
(`cm.gemma_mlp`). in_proj and out_proj stay whole on every rank. The tower
finds its tensor group in its parameters.
"""

from __future__ import annotations

import dataclasses

import torch

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models.common import DEFAULT_POLICY, DtypePolicy
from intact_tpu_torch.ops.attention import multi_head_attention
from intact_tpu_torch.ops.rope import apply_rope
from intact_tpu_torch.parallel import tensor as tensor_parallel


@dataclasses.dataclass(frozen=True)
class ConnectorConfig:
    width: int = 1024
    depth: int = 12
    mlp_dim: int = 4096
    num_heads: int = 8
    head_dim: int = 128
    use_rope: bool = False
    qk_norm: bool = True
    norm_eps: float = 1e-6


def tiny_test_config() -> ConnectorConfig:
    return ConnectorConfig(width=16, depth=2, mlp_dim=32, num_heads=2, head_dim=8)


def init_params(init: cm.Initializer, cfg: ConnectorConfig, in_dim: int, out_dim: int) -> cm.Params:
    d, m, hd, lead = cfg.width, cfg.mlp_dim, cfg.head_dim, (cfg.depth,)
    qdim = cfg.num_heads * hd
    blocks = {
        "ln1": cm.rmsnorm_init(init, d, lead),
        "attn": {
            "q": cm.dense_init(init, d, qdim, use_bias=False, lead=lead),
            "k": cm.dense_init(init, d, qdim, use_bias=False, lead=lead),
            "v": cm.dense_init(init, d, qdim, use_bias=False, lead=lead),
            "o": cm.dense_init(init, qdim, d, use_bias=False, lead=lead),
        },
        "ln2": cm.rmsnorm_init(init, d, lead),
        "mlp": {
            "gate": cm.dense_init(init, d, m, use_bias=False, lead=lead),
            "up": cm.dense_init(init, d, m, use_bias=False, lead=lead),
            "down": cm.dense_init(init, m, d, use_bias=False, lead=lead),
        },
    }
    if cfg.qk_norm:
        blocks["attn"]["q_norm"] = cm.rmsnorm_init(init, hd, lead)
        blocks["attn"]["k_norm"] = cm.rmsnorm_init(init, hd, lead)
    return {
        "in_proj": cm.dense_init(init, in_dim, d),
        "blocks": blocks,
        "final_norm": cm.rmsnorm_init(init, d),
        "out_proj": cm.dense_init(init, d, out_dim),
    }


def apply(params: cm.Params, x: torch.Tensor, cfg: ConnectorConfig,
          policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """[B, N, in_dim] -> [B, N, out_dim], full bidirectional attention."""
    x = cm.dense(params["in_proj"], x, policy)
    b, n, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    positions = torch.arange(n, device=x.device)[None].expand(b, n)
    tp = tensor_parallel.of(params["blocks"])
    for i in range(cfg.depth):
        bp = cm.layer(params["blocks"], i)
        attn, mlp = bp["attn"], bp["mlp"]
        tpa = tensor_parallel.region(tp, attn["q"], h * hd)
        y = tensor_parallel.copy_in(cm.rms_norm(bp["ln1"], x, cfg.norm_eps), tpa)
        q, k, v = (cm.dense_column(attn[name], y, policy, tpa).reshape(b, n, -1, hd) for name in ("q", "k", "v"))
        if cfg.qk_norm:
            q = cm.rms_norm(attn["q_norm"], q, cfg.norm_eps)
            k = cm.rms_norm(attn["k_norm"], k, cfg.norm_eps)
        if cfg.use_rope:
            q = apply_rope(q, positions)
            k = apply_rope(k, positions)
        att = multi_head_attention(q, k, v, mask=None)
        x = x + cm.dense_row(attn["o"], att.reshape(b, n, -1), policy, tpa)
        y = cm.rms_norm(bp["ln2"], x, cfg.norm_eps)
        x = x + cm.gemma_mlp(mlp, y, policy, tensor_parallel.region(tp, mlp["gate"], cfg.mlp_dim))
    x = cm.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return cm.dense(params["out_proj"], x, policy)
