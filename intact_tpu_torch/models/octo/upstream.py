"""The released Octo architecture (rail-berkeley/octo-small, octo-base) and
its checkpoint import (intact_tpu/models/octo/upstream.py):

  SmallStem16 conv tokenizer (256 primary-image tokens at 256 px)
  T5-base language encoder (models/t5.py)
  group projections + learned group positional embeddings
  ViT block transformer with Octo's attention rules (model.py's)
  diffusion action head: learned Fourier features of the raw integer
  timestep -> cond MLP -> MLPResNet epsilon net (swish), 20-step DDPM
  clipped to +-max_action after every step

The stem's convolutions run on NHWC activations with HWIO leaves
(`convnext.conv_nhwc`), and GroupNorm takes min(32, c) groups with fp32
population statistics. The head is fp32.

`convert_octo_params` maps a released checkpoint's flax parameter tree onto
this layout by path-suffix regex over the flattened tree (numpy), so naming
drift between Octo releases fails with a report of every rule that did not
match exactly once; `to_released_tree` is its inverse. `load_octo_checkpoint`
reads a snapshot's flax msgpack (utils/flax_msgpack.py: no msgpack, flax or
JAX needed); an Orbax directory raises, since restoring one needs JAX.
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models import diffusion as diff
from intact_tpu_torch.models import t5 as t5_mod
from intact_tpu_torch.models.common import DEFAULT_POLICY, FP32_POLICY, DtypePolicy
from intact_tpu_torch.models.convnext import conv_nhwc
from intact_tpu_torch.models.octo.model import block_init, block_mask, transformer


@dataclasses.dataclass(frozen=True)
class OctoUpstreamConfig:
    image_size: int = 256
    history: int = 2
    # SmallStem16
    stem_features: tuple = (32, 96, 192, 384)
    stem_kernel: int = 3
    stem_stride: int = 2
    stem_embed_features: int = 512
    # transformer (octo-small = ViT-S)
    width: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_dim: int = 1536
    # language
    t5: t5_mod.T5Config = dataclasses.field(default_factory=t5_mod.t5_base)
    max_lang_tokens: int = 16
    # action head
    horizon: int = 4
    action_dim: int = 7
    diffusion_steps: int = 20
    time_dim: int = 32
    head_hidden: int = 256
    head_blocks: int = 3
    max_action: float = 5.0
    norm_eps: float = 1e-6

    @property
    def n_patches(self) -> int:
        return (self.image_size // 16) ** 2


def octo_small() -> OctoUpstreamConfig:
    return OctoUpstreamConfig()


def octo_base() -> OctoUpstreamConfig:
    return OctoUpstreamConfig(width=768, depth=12, num_heads=12, mlp_dim=3072)


def tiny_test_config() -> OctoUpstreamConfig:
    return OctoUpstreamConfig(
        image_size=32, history=2, stem_features=(4, 8, 8, 8),
        stem_embed_features=16, width=16, depth=2, num_heads=2, mlp_dim=32,
        t5=t5_mod.tiny_test_config(), max_lang_tokens=6,
        horizon=2, action_dim=3, diffusion_steps=4, time_dim=8,
        head_hidden=16, head_blocks=2,
    )


# ---------------------------------------------------------------------------
# init (the layout the converter fills)
# ---------------------------------------------------------------------------

def init_params(init: cm.Initializer, cfg: OctoUpstreamConfig) -> cm.Params:
    d, k3 = cfg.width, cfg.stem_kernel
    stem, in_ch = {}, 3
    for i, feat in enumerate(cfg.stem_features):
        stem[f"conv_{i}"] = {"kernel": cm.lecun_normal(init, (k3, k3, in_ch, feat), k3 * k3 * in_ch),
                             "bias": init.zeros((feat,))}
        stem[f"gn_{i}"] = {"scale": init.ones((feat,)), "bias": init.zeros((feat,))}
        in_ch = feat
    stem["embed"] = {"kernel": cm.lecun_normal(init, (1, 1, in_ch, cfg.stem_embed_features), in_ch),
                     "bias": init.zeros((cfg.stem_embed_features,))}
    return {
        "stem_primary": stem,
        "t5": t5_mod.init_params(init, cfg.t5),
        "obs_primary_projection": cm.dense_init(init, cfg.stem_embed_features, d),
        "task_language_projection": cm.dense_init(init, cfg.t5.d_model, d),
        "obs_primary_pos_embedding": init.normal((1, cfg.history, cfg.n_patches, d), 0.02),
        "task_language_pos_embedding": init.normal((1, cfg.max_lang_tokens, d), 0.02),
        "readout_action_pos_embedding": init.normal((1, cfg.history, 1, d), 0.02),
        "blocks": block_init(init, d, cfg.mlp_dim, cfg.depth),
        "encoder_norm": cm.layernorm_init(init, d),
        "head": {
            "fourier": {"kernel": init.normal((1, cfg.time_dim // 2), 0.2)},
            "cond_mlp": {"fc1": cm.dense_init(init, cfg.time_dim, 2 * cfg.time_dim),
                         "fc2": cm.dense_init(init, 2 * cfg.time_dim, cfg.time_dim)},
            "reverse": _mlp_resnet_init(init, cfg),
        },
    }


def _mlp_resnet_init(init: cm.Initializer, cfg: OctoUpstreamConfig) -> cm.Params:
    hidden = cfg.head_hidden
    p = {"dense_in": cm.dense_init(init, cfg.time_dim + cfg.width + cfg.horizon * cfg.action_dim, hidden)}
    for i in range(cfg.head_blocks):
        p[f"block_{i}"] = {"ln": cm.layernorm_init(init, hidden), "fc1": cm.dense_init(init, hidden, hidden * 4),
                           "fc2": cm.dense_init(init, hidden * 4, hidden)}
    p["dense_out"] = cm.dense_init(init, hidden, cfg.horizon * cfg.action_dim)
    return p


def init(cfg: OctoUpstreamConfig, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    return init_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _group_norm(p: cm.Params, x: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC x with min(groups, c) groups, fp32 statistics
    (population variance)."""
    b, h, w, c = x.shape
    g = min(groups, c)
    x32 = x.to(torch.float32).reshape(b, h, w, g, c // g)
    mean = x32.mean(dim=(1, 2, 4), keepdim=True)
    var = x32.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)).to(x.dtype)


def small_stem_encode(stem: cm.Params, images: torch.Tensor, cfg: OctoUpstreamConfig,
                      policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """uint8 or float images [B, H, W, 3] -> [B, n_patches, stem_embed]
    (uint8 maps to x / 127.5 - 1 first)."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / 127.5 - 1.0
    x = policy.cast(x)
    for i in range(len(cfg.stem_features)):
        x = conv_nhwc(stem[f"conv_{i}"], x, cfg.stem_stride, policy, padding=1)
        x = torch.relu(_group_norm(stem[f"gn_{i}"], x, groups=32))
    x = conv_nhwc(stem["embed"], x, 1, policy)
    b, gh, gw, c = x.shape
    return x.reshape(b, gh * gw, c)


def encode(params, images, img_masks, lang_tokens, lang_masks, cfg: OctoUpstreamConfig,
           policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """-> readout embeddings [B, history, width]; images [B, T, H, W, 3],
    token layout and attention rules as model.py's."""
    b, t = images.shape[:2]
    n_patch, d = cfg.n_patches, cfg.width
    obs = small_stem_encode(params["stem_primary"], images.reshape(b * t, *images.shape[2:]), cfg, policy)
    obs = cm.dense(params["obs_primary_projection"], obs, policy)
    obs = obs.reshape(b, t, n_patch, d) + policy.cast(params["obs_primary_pos_embedding"])

    lang = t5_mod.encode(params["t5"], lang_tokens, lang_masks, cfg.t5, policy)
    lang = cm.dense(params["task_language_projection"], lang, policy)
    lt = lang.shape[1]
    lang = lang + policy.cast(params["task_language_pos_embedding"][:, :lt])

    readout = policy.cast(params["readout_action_pos_embedding"]).expand(b, t, 1, d)
    frames = torch.cat([obs, readout], dim=2)  # [B, T, P + 1, D]
    tokens = torch.cat([lang, frames.reshape(b, t * (n_patch + 1), d)], dim=1)

    mask = block_mask(lang_masks, img_masks, n_patch)
    tokens = transformer(params["blocks"], tokens, mask, cfg.num_heads, cfg.norm_eps, policy)
    tokens = cm.layer_norm(params["encoder_norm"], tokens, cfg.norm_eps)
    readout_idx = lt + torch.arange(t, device=tokens.device) * (n_patch + 1) + n_patch
    return tokens[:, readout_idx]


# ---------------------------------------------------------------------------
# diffusion action head (ScoreActor)
# ---------------------------------------------------------------------------

def _eps_fn(params, cfg: OctoUpstreamConfig, x_t, time, cond):
    """x_t [B, horizon, action_dim], time [B] (integer steps), cond [B,
    width] -> eps, in fp32."""
    head = params["head"]
    # the Fourier features take the raw integer timestep in [0,
    # diffusion_steps): the released kernel was trained at that scale
    t_in = time.to(torch.float32)[:, None]
    f = (2.0 * math.pi * t_in) @ head["fourier"]["kernel"].to(torch.float32)
    t_ff = torch.cat([torch.cos(f), torch.sin(f)], dim=-1)  # [B, time_dim]
    c = F.silu(cm.dense(head["cond_mlp"]["fc1"], t_ff, FP32_POLICY))
    c = cm.dense(head["cond_mlp"]["fc2"], c, FP32_POLICY)

    h = torch.cat([c, cond.to(torch.float32), x_t.reshape(x_t.shape[0], -1)], dim=-1)
    r = head["reverse"]
    h = cm.dense(r["dense_in"], h, FP32_POLICY)
    for i in range(cfg.head_blocks):
        blk = r[f"block_{i}"]
        y = cm.layer_norm(blk["ln"], h, cfg.norm_eps)
        y = F.silu(cm.dense(blk["fc1"], y, FP32_POLICY))
        h = h + cm.dense(blk["fc2"], y, FP32_POLICY)
    return cm.dense(r["dense_out"], F.silu(h), FP32_POLICY).reshape(x_t.shape)


def sample_actions(params, generator, images, img_masks, lang_tokens, lang_masks, state, cfg: OctoUpstreamConfig,
                   policy: DtypePolicy = DEFAULT_POLICY, noise=None, step_noise=None):
    """DDPM over every step, x clipped to [-max_action, max_action] after each
    (upstream Octo's per-step clipping) -> [B, horizon, action_dim] fp32.
    `noise` fixes x_T; `step_noise` gives the per-step draws."""
    readouts = encode(params, images, img_masks, lang_tokens, lang_masks, cfg, policy)
    return diff.ddpm_sample(
        diff.make_schedule(cfg.diffusion_steps), lambda x, t, c: _eps_fn(params, cfg, x, t, c), generator,
        (images.shape[0], cfg.horizon, cfg.action_dim), readouts[:, -1], clip_value=cfg.max_action,
        init_noise=noise, step_noise=step_noise)


def compute_loss(params, rng: np.random.Generator | None, batch: dict, cfg: OctoUpstreamConfig,
                 policy: DtypePolicy = DEFAULT_POLICY, t_int=None, noise=None):
    """Epsilon-MSE on the last readout -> (loss, {"l2_loss", "losses"});
    `rng` draws the timesteps and noise that are not given."""
    readouts = encode(params, batch["images"], batch["img_masks"], batch["lang_tokens"], batch["lang_masks"], cfg,
                      policy)
    loss, aux = diff.training_loss(
        diff.make_schedule(cfg.diffusion_steps), lambda x, t, c: _eps_fn(params, cfg, x, t, c), rng,
        batch["actions"].to(torch.float32), readouts[:, -1], t_int=t_int, noise=noise)
    return loss, {"l2_loss": loss, "losses": aux["losses"]}


# ---------------------------------------------------------------------------
# checkpoint import (numpy)
# ---------------------------------------------------------------------------

def _assign(tree: dict, path: tuple, value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node[k]
    if node[path[-1]].shape != value.shape:
        raise ValueError(f"shape mismatch at {'/'.join(map(str, path))}: checkpoint {value.shape} vs model "
                         f"{node[path[-1]].shape}")
    node[path[-1]] = np.asarray(value).astype(np.float32)


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def convert_octo_params(ckpt_tree: dict, cfg: OctoUpstreamConfig, strict: bool = True) -> cm.Params:
    """Released Octo flax parameter tree -> this module's layout, as host
    (CPU) fp32 tensors.

    Matching is by path-suffix regex over the flattened tree, so the exact
    module nesting ('octo_transformer/...') may vary between releases. With
    strict, every rule must match exactly once, else this raises with a
    report of the ones that did not; without, a leaf no rule filled stays
    zero."""
    flat = cm.flatten_paths(ckpt_tree)
    params = cm.tree_map(lambda x: np.zeros(tuple(x.shape), np.float32), init(cfg, device="meta"))
    missing: list[str] = []

    def one(pattern: str):
        rx = re.compile(pattern)
        hits = [np.asarray(v) for k, v in flat.items() if rx.search(k)]
        if len(hits) == 1:
            return hits[0]
        missing.append(f"{pattern} -> {len(hits)} matches")
        return None

    def put_layer(path: tuple, i: int, value) -> None:
        stack = _get(params, path)
        stack[i] = value.reshape(stack[i].shape)  # a value of another size raises here

    d = cfg.width
    # ---- ViT encoder blocks ([d, h, hd] q/k/v and [h, hd, d] out kernels fold to [d, d]) ----
    for i in range(cfg.depth):
        blk = rf"encoderblock_{i}/"
        for ours, theirs in (("q", "query"), ("k", "key"), ("v", "value"), ("o", "out")):
            kern = one(blk + rf"MultiHeadDotProductAttention_0/{theirs}/kernel$")
            bias = one(blk + rf"MultiHeadDotProductAttention_0/{theirs}/bias$")
            if kern is not None and bias is not None:
                put_layer(("blocks", "attn", ours, "kernel"), i, kern.reshape(d, d))
                put_layer(("blocks", "attn", ours, "bias"), i, bias.reshape(d))
        for ours, theirs in (("ln1", "LayerNorm_0"), ("ln2", "LayerNorm_1")):
            for field in ("scale", "bias"):
                v = one(blk + rf"{theirs}/{field}$")
                if v is not None:
                    put_layer(("blocks", ours, field), i, v)
        for ours, theirs in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
            for field in ("kernel", "bias"):
                v = one(blk + rf"MlpBlock_0/{theirs}/{field}$")
                if v is not None:
                    put_layer(("blocks", "mlp", ours, field), i, v)

    # ---- norms, projections, embeddings ----
    for path, pattern in (
        (("encoder_norm", "scale"), r"encoder_norm/scale$"),
        (("encoder_norm", "bias"), r"encoder_norm/bias$"),
        (("obs_primary_projection", "kernel"), r"obs_primary_projection/kernel$"),
        (("obs_primary_projection", "bias"), r"obs_primary_projection/bias$"),
        (("task_language_projection", "kernel"), r"task_language_projection/kernel$"),
        (("task_language_projection", "bias"), r"task_language_projection/bias$"),
        (("obs_primary_pos_embedding",), r"obs_primary_pos_embedding$"),
        (("task_language_pos_embedding",), r"task_language_pos_embedding$"),
        (("readout_action_pos_embedding",), r"readout_action_pos_embedding$"),
    ):
        v = one(pattern)
        if v is not None:
            target = _get(params, path)
            _assign(params, path, v.reshape(target.shape) if v.size == target.size else v)

    # ---- SmallStem ----
    for i in range(len(cfg.stem_features)):
        for field, gn_field in (("kernel", "scale"), ("bias", "bias")):
            v = one(rf"observation_tokenizers_primary/.*Conv_{i}/{field}$")
            if v is not None:
                _assign(params, ("stem_primary", f"conv_{i}", field), v)
            g = one(rf"observation_tokenizers_primary/.*GroupNorm_{i}/{gn_field}$")
            if g is not None:
                _assign(params, ("stem_primary", f"gn_{i}", gn_field), g)
    emb_k = one(r"observation_tokenizers_primary/.*embedding/kernel$")
    emb_b = one(r"observation_tokenizers_primary/.*embedding/bias$")
    if emb_k is not None and emb_b is not None:
        _assign(params, ("stem_primary", "embed", "kernel"), emb_k)
        _assign(params, ("stem_primary", "embed", "bias"), emb_b)

    # ---- T5 (flax layout: kernels already [in, out]) ----
    emb = one(r"task_tokenizers_language/.*shared/embedding$")
    if emb is not None:
        _assign(params, ("t5", "embed", "embedding"), emb)
    rel = one(r"task_tokenizers_language/.*block/0/layer/0/SelfAttention/relative_attention_bias/embedding$")
    if rel is not None:
        _assign(params, ("t5", "rel_bias"), rel)
    for i in range(cfg.t5.num_layers):
        base = rf"task_tokenizers_language/.*block/{i}/layer/"
        for name in ("q", "k", "v", "o"):
            v = one(base + rf"0/SelfAttention/{name}/kernel$")
            if v is not None:
                put_layer(("t5", "blocks", "attn", name, "kernel"), i, v)
        for ours, idx in (("ln1", "0"), ("ln2", "1")):
            v = one(base + rf"{idx}/layer_norm/weight$")
            if v is not None:
                put_layer(("t5", "blocks", ours, "scale"), i, v)
        for name in ("wi", "wo"):
            v = one(base + rf"1/DenseReluDense/{name}/kernel$")
            if v is not None:
                put_layer(("t5", "blocks", "mlp", name, "kernel"), i, v)
    fn = one(r"task_tokenizers_language/.*final_layer_norm/weight$")
    if fn is not None:
        _assign(params, ("t5", "final_norm", "scale"), fn)

    # ---- diffusion head ----
    # FourierFeatures stores its kernel [out // 2, in] upstream; this module
    # multiplies t [B, in] @ kernel [in, out // 2]
    ff = one(r"heads_action/.*FourierFeatures_0/kernel$")
    if ff is not None:
        target = _get(params, ("head", "fourier", "kernel"))
        if ff.shape == target.shape[::-1] and ff.shape != target.shape:
            ff = ff.T
        _assign(params, ("head", "fourier", "kernel"), ff)
    for path, pattern in (
        (("head", "cond_mlp", "fc1", "kernel"), r"heads_action/.*cond_encoder/Dense_0/kernel$"),
        (("head", "cond_mlp", "fc1", "bias"), r"heads_action/.*cond_encoder/Dense_0/bias$"),
        (("head", "cond_mlp", "fc2", "kernel"), r"heads_action/.*cond_encoder/Dense_1/kernel$"),
        (("head", "cond_mlp", "fc2", "bias"), r"heads_action/.*cond_encoder/Dense_1/bias$"),
        (("head", "reverse", "dense_in", "kernel"), r"heads_action/.*reverse_network/Dense_0/kernel$"),
        (("head", "reverse", "dense_in", "bias"), r"heads_action/.*reverse_network/Dense_0/bias$"),
        (("head", "reverse", "dense_out", "kernel"), r"heads_action/.*reverse_network/Dense_1/kernel$"),
        (("head", "reverse", "dense_out", "bias"), r"heads_action/.*reverse_network/Dense_1/bias$"),
    ):
        v = one(pattern)
        if v is not None:
            _assign(params, path, v)
    for i in range(cfg.head_blocks):
        base = rf"heads_action/.*reverse_network/MLPResNetBlock_{i}/"
        for path, pattern in (
            (("ln", "scale"), base + r"LayerNorm_0/scale$"),
            (("ln", "bias"), base + r"LayerNorm_0/bias$"),
            (("fc1", "kernel"), base + r"Dense_0/kernel$"),
            (("fc1", "bias"), base + r"Dense_0/bias$"),
            (("fc2", "kernel"), base + r"Dense_1/kernel$"),
            (("fc2", "bias"), base + r"Dense_1/bias$"),
        ):
            v = one(pattern)
            if v is not None:
                _assign(params, ("head", "reverse", f"block_{i}") + path, v)

    if strict and missing:
        raise ValueError("octo checkpoint import: %d rules did not match exactly once:\n  " % len(missing)
                         + "\n  ".join(missing[:40]))
    return cm.tree_map(torch.from_numpy, params)


def to_released_tree(params: cm.Params, cfg: OctoUpstreamConfig) -> dict:
    """This module's parameter tree -> the released checkpoint's flax layout
    (numpy fp32; string layer indices under the T5 encoder, [d, h, hd] and
    [h, hd, d] attention kernels, the Fourier kernel [out // 2, in]): the
    inverse of `convert_octo_params`."""
    p = cm.tree_map(lambda x: x.detach().to("cpu", torch.float32).numpy(), params)
    d, h = cfg.width, cfg.num_heads
    hd = d // h
    b = p["blocks"]

    def lin(node):
        return {"kernel": node["kernel"], "bias": node["bias"]}

    def norm(node):
        return {"scale": node["scale"], "bias": node["bias"]}

    enc = {}
    for i in range(cfg.depth):
        a = b["attn"]
        enc[f"encoderblock_{i}"] = {
            "LayerNorm_0": {"scale": b["ln1"]["scale"][i], "bias": b["ln1"]["bias"][i]},
            "MultiHeadDotProductAttention_0": {
                **{theirs: {"kernel": a[ours]["kernel"][i].reshape(d, h, hd), "bias": a[ours]["bias"][i].reshape(h, hd)}
                   for ours, theirs in (("q", "query"), ("k", "key"), ("v", "value"))},
                "out": {"kernel": a["o"]["kernel"][i].reshape(h, hd, d), "bias": a["o"]["bias"][i]},
            },
            "LayerNorm_1": {"scale": b["ln2"]["scale"][i], "bias": b["ln2"]["bias"][i]},
            "MlpBlock_0": {"Dense_0": {"kernel": b["mlp"]["fc1"]["kernel"][i], "bias": b["mlp"]["fc1"]["bias"][i]},
                           "Dense_1": {"kernel": b["mlp"]["fc2"]["kernel"][i], "bias": b["mlp"]["fc2"]["bias"][i]}},
        }
    enc["encoder_norm"] = norm(p["encoder_norm"])

    stem = {}
    for i in range(len(cfg.stem_features)):
        stem[f"Conv_{i}"] = lin(p["stem_primary"][f"conv_{i}"])
        stem[f"GroupNorm_{i}"] = norm(p["stem_primary"][f"gn_{i}"])
    stem["embedding"] = lin(p["stem_primary"]["embed"])

    t5p, tb = p["t5"], p["t5"]["blocks"]
    blocks = {}
    for i in range(cfg.t5.num_layers):
        attn = {name: {"kernel": tb["attn"][name]["kernel"][i]} for name in ("q", "k", "v", "o")}
        if i == 0:
            attn["relative_attention_bias"] = {"embedding": t5p["rel_bias"]}
        blocks[str(i)] = {"layer": {
            "0": {"SelfAttention": attn, "layer_norm": {"weight": tb["ln1"]["scale"][i]}},
            "1": {"DenseReluDense": {name: {"kernel": tb["mlp"][name]["kernel"][i]} for name in ("wi", "wo")},
                  "layer_norm": {"weight": tb["ln2"]["scale"][i]}},
        }}

    head, r = p["head"], p["head"]["reverse"]
    return {
        "octo_transformer": {
            "observation_tokenizers_primary": {"SmallStem16_0": stem},
            "task_tokenizers_language": {"hf_model": {
                "shared": {"embedding": t5p["embed"]["embedding"]},
                "encoder": {"block": blocks, "final_layer_norm": {"weight": t5p["final_norm"]["scale"]}},
            }},
            "obs_primary_projection": lin(p["obs_primary_projection"]),
            "task_language_projection": lin(p["task_language_projection"]),
            "obs_primary_pos_embedding": p["obs_primary_pos_embedding"],
            "task_language_pos_embedding": p["task_language_pos_embedding"],
            "readout_action_pos_embedding": p["readout_action_pos_embedding"],
            "BlockTransformer_0": {"Transformer_0": enc},
        },
        "heads_action": {"diffusion_model": {"ScoreActor_0": {
            "FourierFeatures_0": {"kernel": np.ascontiguousarray(head["fourier"]["kernel"].T)},
            "cond_encoder": {"Dense_0": lin(head["cond_mlp"]["fc1"]), "Dense_1": lin(head["cond_mlp"]["fc2"])},
            "reverse_network": {
                "Dense_0": lin(r["dense_in"]),
                **{f"MLPResNetBlock_{i}": {"LayerNorm_0": norm(r[f"block_{i}"]["ln"]),
                                           "Dense_0": lin(r[f"block_{i}"]["fc1"]),
                                           "Dense_1": lin(r[f"block_{i}"]["fc2"])} for i in range(cfg.head_blocks)},
                "Dense_1": lin(r["dense_out"]),
            },
        }}},
    }


def load_octo_checkpoint(path: str, cfg: OctoUpstreamConfig) -> cm.Params:
    """A released Octo snapshot directory (the HF layout of rail-berkeley/octo-*)
    holding its parameters as flax msgpack -> converted host tree. An Orbax
    directory raises: restoring one needs JAX (convert it to msgpack with
    `flax.serialization.msgpack_serialize` where JAX is installed)."""
    from intact_tpu_torch.utils import flax_msgpack

    p = Path(path)
    tree = None
    for c in sorted(p.glob("*.msgpack")) + [p / "params", p]:
        if c.is_file() and c.suffix == ".msgpack":
            tree = flax_msgpack.unpackb(c.read_bytes())
            break
        if (c / "_METADATA").exists() or (c / "checkpoint").exists():
            raise RuntimeError(f"{c} is an Orbax checkpoint; restoring it needs JAX, which the PyTorch port does not "
                               "use: save its parameters as flax msgpack (flax.serialization.msgpack_serialize) "
                               "and pass that snapshot")
    if tree is None:
        raise FileNotFoundError(f"no octo params found under {path}")
    # released trees nest under {"octo_transformer", "heads_action"}, possibly
    # wrapped in {"params": ...} or {"model": {"params": ...}}
    for key in ("model", "params"):
        if isinstance(tree, dict) and key in tree and isinstance(tree[key], dict):
            tree = tree[key]
    return convert_octo_params(tree, cfg)
