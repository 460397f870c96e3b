"""T5 encoder (v1.0, the t5-base family): Octo's language encoder
(intact_tpu/models/t5.py).

Conventions, as in the reference (transformers T5EncoderModel):
  * T5LayerNorm: x * rsqrt(mean(x^2) + eps) * w, no mean subtraction, fp32
    statistics;
  * attention without the 1/sqrt(d) scale, plus an additive fp32 bias: the
    learned relative-position bias of layer 0 (shared by every layer) and
    finfo(float32).min on padded keys; softmax in fp32;
  * pre-norm residual blocks, ReLU feed-forward (DenseReluDense).

The relative-position buckets are computed on the host CPU in fp32, the
reference's formula op for op, and moved to the device: they depend only on
the sequence length, and a device `log` could round a bucket boundary
differently. Nothing here imports transformers: `from_hf_state_dict` maps a
torch state dict of T5EncoderModel naming.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models.common import DEFAULT_POLICY, DtypePolicy


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32_128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_heads: int = 12
    num_layers: int = 12
    rel_buckets: int = 32
    rel_max_distance: int = 128
    norm_eps: float = 1e-6


def t5_base() -> T5Config:
    return T5Config()


def tiny_test_config() -> T5Config:
    return T5Config(vocab_size=99, d_model=32, d_kv=8, d_ff=64, num_heads=4, num_layers=2)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(init: cm.Initializer, cfg: T5Config) -> cm.Params:
    d, inner, lead = cfg.d_model, cfg.num_heads * cfg.d_kv, (cfg.num_layers,)
    return {
        "embed": cm.embed_init(init, cfg.vocab_size, d),
        "rel_bias": init.normal((cfg.rel_buckets, cfg.num_heads), 0.02),
        "blocks": {
            "ln1": {"scale": init.ones((*lead, d))},
            "attn": {
                "q": cm.dense_init(init, d, inner, use_bias=False, lead=lead),
                "k": cm.dense_init(init, d, inner, use_bias=False, lead=lead),
                "v": cm.dense_init(init, d, inner, use_bias=False, lead=lead),
                "o": cm.dense_init(init, inner, d, use_bias=False, lead=lead),
            },
            "ln2": {"scale": init.ones((*lead, d))},
            "mlp": {
                "wi": cm.dense_init(init, d, cfg.d_ff, use_bias=False, lead=lead),
                "wo": cm.dense_init(init, cfg.d_ff, d, use_bias=False, lead=lead),
            },
        },
        "final_norm": {"scale": init.ones((d,))},
    }


def init(cfg: T5Config, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    return init_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def t5_layer_norm(p: cm.Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)).to(x.dtype)


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional bucketing (HF T5Attention._relative_position_bucket),
    int32, in the reference's fp32 arithmetic: log(rp / max_exact + 1e-9),
    scaled, truncated toward zero."""
    num_buckets //= 2
    buckets = (relative_position > 0).to(torch.int32) * num_buckets
    rp = relative_position.abs().to(torch.int32)
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(rp.to(torch.float32) / max_exact + 1e-9)
                         / math.log(max_distance / max_exact) * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(rp < max_exact, rp, large)


def _position_bias(params: cm.Params, q_len: int, k_len: int, cfg: T5Config) -> torch.Tensor:
    """-> [1, heads, q_len, k_len] learned relative-position bias (the
    buckets from the host, the table's rows gathered on its device)."""
    ctx = torch.arange(q_len, dtype=torch.int32)[:, None]
    mem = torch.arange(k_len, dtype=torch.int32)[None, :]
    buckets = relative_position_bucket(mem - ctx, cfg.rel_buckets, cfg.rel_max_distance)
    bias = params["rel_bias"][buckets.to(params["rel_bias"].device).long()]  # [q, k, heads]
    return bias.permute(2, 0, 1)[None]


def encode(params: cm.Params, tokens: torch.Tensor, mask: torch.Tensor, cfg: T5Config,
           policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """int [B, L] tokens and bool [B, L] mask -> [B, L, d_model] final-normed
    encoder states (compute dtype)."""
    b, n = tokens.shape
    h, dk = cfg.num_heads, cfg.d_kv
    x = cm.embed_lookup(params["embed"], tokens, policy)  # no sqrt(d) scaling
    pos_bias = _position_bias(params, n, n, cfg).to(torch.float32)
    key_mask = torch.where(mask[:, None, None, :].bool(), 0.0, torch.finfo(torch.float32).min)
    bias = pos_bias + key_mask  # [B, H, L, L]

    for i in range(cfg.num_layers):
        bp = cm.layer(params["blocks"], i)
        y = t5_layer_norm(bp["ln1"], x, cfg.norm_eps)
        q = cm.dense(bp["attn"]["q"], y, policy).reshape(b, n, h, dk)
        k = cm.dense(bp["attn"]["k"], y, policy).reshape(b, n, h, dk)
        v = cm.dense(bp["attn"]["v"], y, policy).reshape(b, n, h, dk)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) + bias
        att = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, n, h * dk)
        x = x + cm.dense(bp["attn"]["o"], out, policy)

        y = t5_layer_norm(bp["ln2"], x, cfg.norm_eps)
        x = x + cm.dense(bp["mlp"]["wo"], torch.relu(cm.dense(bp["mlp"]["wi"], y, policy)), policy)
    return t5_layer_norm(params["final_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# HF torch checkpoint -> params
# ---------------------------------------------------------------------------

def _embed_weight(sd: dict, prefix: str):
    """The shared or the encoder-scoped embedding; raises naming both keys."""
    for key in ("shared.weight", prefix + ".embed_tokens.weight"):
        if key in sd:
            return sd[key]
    raise KeyError(f"T5 state dict has neither 'shared.weight' nor '{prefix}.embed_tokens.weight'")


def from_hf_state_dict(sd: dict, cfg: T5Config, prefix: str = "encoder") -> cm.Params:
    """Flat state dict of T5EncoderModel naming ({name: array or tensor}) ->
    host parameter tree (CPU tensors): Linear weights [out, in] transposed to
    kernels [in, out], layers stacked."""
    from intact_tpu_torch.models.hf_import import stack, t, tensor

    f = prefix + ".block.{i}.layer."
    n = cfg.num_layers

    def lin(name):
        return {"kernel": stack(sd, f + name + ".weight", n, t)}

    return {
        "embed": {"embedding": tensor(_embed_weight(sd, prefix))},
        "rel_bias": tensor(sd[prefix + ".block.0.layer.0.SelfAttention.relative_attention_bias.weight"]),
        "blocks": {
            "ln1": {"scale": stack(sd, f + "0.layer_norm.weight", n)},
            "attn": {name: lin(f"0.SelfAttention.{name}") for name in ("q", "k", "v", "o")},
            "ln2": {"scale": stack(sd, f + "1.layer_norm.weight", n)},
            "mlp": {name: lin(f"1.DenseReluDense.{name}") for name in ("wi", "wo")},
        },
        "final_norm": {"scale": tensor(sd[prefix + ".final_layer_norm.weight"])},
    }
