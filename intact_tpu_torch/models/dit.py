"""DiT action head: a transformer denoiser with adaLN-Zero modulation (intact_tpu/models/dit.py).

Noisy action tokens are denoised by transformer blocks whose layernorm
shift, scale and gate come from an MLP over the timestep embedding plus the
condition embedding: MVLA's alternative action decoder, driven through
models/diffusion.py. Its attention is the plain path (no mask).

Over tensor ranks (Megatron-style, parallel/tensor.py): where the heads
split, q, k and v are column-parallel (their replicated biases sliced with
the columns), the attention runs the rank's heads and o is row-parallel (the
whole bias added once after the sum); the MLP's fc1 column- and fc2
row-parallel (`cm.gelu_mlp`). The modulation (`ada`, `final`) and the
embeddings stay whole: every rank computes the same. The tower finds its
tensor group in its parameters.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models.common import DEFAULT_POLICY, FP32_POLICY, DtypePolicy
from intact_tpu_torch.models.diffusion import timestep_embedding
from intact_tpu_torch.ops.attention import multi_head_attention
from intact_tpu_torch.parallel import tensor as tensor_parallel


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    width: int = 384  # DiT-S
    depth: int = 6
    num_heads: int = 6
    mlp_ratio: int = 4
    action_dim: int = 7
    horizon: int = 4
    cond_dim: int = 384


def tiny_test_config() -> DiTConfig:
    return DiTConfig(width=32, depth=2, num_heads=2, action_dim=3, horizon=4, cond_dim=16)


def init_params(init: cm.Initializer, cfg: DiTConfig) -> cm.Params:
    d, m, lead = cfg.width, cfg.width * cfg.mlp_ratio, (cfg.depth,)
    return {
        "x_proj": cm.dense_init(init, cfg.action_dim, d),
        "pos_embed": init.normal((1, cfg.horizon, d), 0.02),
        "t_mlp": {"fc1": cm.dense_init(init, d, d), "fc2": cm.dense_init(init, d, d)},
        "cond_proj": cm.dense_init(init, cfg.cond_dim, d),
        "blocks": {
            "attn": {name: cm.dense_init(init, d, d, lead=lead) for name in ("q", "k", "v", "o")},
            "mlp": {"fc1": cm.dense_init(init, d, m, lead=lead), "fc2": cm.dense_init(init, m, d, lead=lead)},
            # adaLN-Zero: 6 modulation vectors, zero-init so blocks start as identity
            "ada": {"kernel": init.zeros((*lead, d, 6 * d)), "bias": init.zeros((*lead, 6 * d))},
        },
        "final": {
            "ada": {"kernel": init.zeros((d, 2 * d)), "bias": init.zeros((2 * d,))},
            "proj": {"kernel": init.zeros((d, cfg.action_dim)), "bias": init.zeros((cfg.action_dim,))},
        },
    }


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _ln(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free layernorm in fp32 (adaLN supplies scale and shift)."""
    x32 = x.to(torch.float32)
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def apply(params: cm.Params, x_t: torch.Tensor, t_int: torch.Tensor, cond: torch.Tensor, cfg: DiTConfig,
          policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """x_t [B, horizon, action_dim], t_int [B], cond [B, cond_dim] -> eps
    [B, horizon, action_dim] (fp32 head)."""
    b = x_t.shape[0]
    d, h = cfg.width, cfg.num_heads
    hd = d // h

    x = cm.dense(params["x_proj"], policy.cast(x_t), policy) + policy.cast(params["pos_embed"])
    t_emb = timestep_embedding(t_int, d)
    t_emb = cm.dense(params["t_mlp"]["fc2"], F.silu(cm.dense(params["t_mlp"]["fc1"], policy.cast(t_emb), policy)),
                     policy)
    c = F.silu(t_emb + cm.dense(params["cond_proj"], policy.cast(cond), policy))

    tp = tensor_parallel.of(params["blocks"])
    for i in range(cfg.depth):
        bp = cm.layer(params["blocks"], i)
        attn, mlp = bp["attn"], bp["mlp"]
        sh1, sc1, g1, sh2, sc2, g2 = cm.dense(bp["ada"], c, policy).chunk(6, dim=-1)
        n = x.shape[1]
        tpa = tensor_parallel.region(tp, attn["q"], d)
        y = tensor_parallel.copy_in(_modulate(_ln(x), sh1, sc1), tpa)
        q, k, v = (cm.dense_column(attn[name], y, policy, tpa).reshape(b, n, -1, hd) for name in ("q", "k", "v"))
        att = multi_head_attention(q, k, v, mask=None)
        x = x + g1[:, None, :] * cm.dense_row(attn["o"], att.reshape(b, n, -1), policy, tpa)
        y = _modulate(_ln(x), sh2, sc2)
        x = x + g2[:, None, :] * cm.gelu_mlp(mlp, y, policy, tensor_parallel.region(tp, mlp["fc1"], d * cfg.mlp_ratio))

    sh, sc = cm.dense(params["final"]["ada"], c, policy).chunk(2, dim=-1)
    x = _modulate(_ln(x), sh, sc)
    return cm.dense(params["final"]["proj"], x.to(torch.float32), FP32_POLICY)
