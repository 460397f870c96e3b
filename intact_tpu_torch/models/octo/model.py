"""Native Octo: transformer + diffusion action head (intact_tpu/models/octo/model.py).

Token layout per batch row (history T frames):

  [ task language (Lt) | obs_1 (P) | readout_1 | ... | obs_T (P) | readout_T ]

Attention rules (Octo's block structure):
  * task tokens attend task tokens;
  * obs_t tokens attend task + obs_{<=t} (never readouts);
  * readout_t attends task + obs_{<=t} + itself.
Missing history frames (img_masks False) mask out their whole frame block as
keys. The rules are a static [N, N] template per configuration, combined
with the batch's padding at run time. Attention is the plain path, as in the
reference.

Action head: a FiLM-MLP epsilon denoiser over the flattened action chunk,
conditioned on the last readout embedding, always in fp32; sampled with DDPM
over every step when sample_steps >= diffusion_steps, else strided DDIM
(models/diffusion.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models import diffusion as diff
from intact_tpu_torch.models.common import DEFAULT_POLICY, FP32_POLICY, DtypePolicy
from intact_tpu_torch.models.octo.config import OctoConfig
from intact_tpu_torch.ops.attention import multi_head_attention

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def block_init(init: cm.Initializer, width: int, mlp_dim: int, depth: int) -> cm.Params:
    """`depth` pre-norm ViT blocks, stacked [depth, ...] (DreamVLA's backbone
    takes the same layout)."""
    lead = (depth,)
    return {
        "ln1": cm.layernorm_init(init, width, lead),
        "attn": {name: cm.dense_init(init, width, width, lead=lead) for name in ("q", "k", "v", "o")},
        "ln2": cm.layernorm_init(init, width, lead),
        "mlp": {"fc1": cm.dense_init(init, width, mlp_dim, lead=lead),
                "fc2": cm.dense_init(init, mlp_dim, width, lead=lead)},
    }


def init_params(init: cm.Initializer, cfg: OctoConfig) -> cm.Params:
    d = cfg.width
    n_patch = (cfg.image_size // cfg.patch_size) ** 2
    adim = cfg.action_dim * cfg.horizon
    params = {
        "patch_embed": cm.dense_init(init, cfg.patch_size * cfg.patch_size * 3, d),
        "obs_pos_embed": init.normal((1, cfg.history, n_patch, d), 0.02),
        "lang_embed": cm.embed_init(init, cfg.vocab_size, d),
        "readout_embed": init.normal((1, cfg.history, d), 0.02),
        "blocks": block_init(init, d, cfg.mlp_dim, cfg.depth),
        "final_ln": cm.layernorm_init(init, d),
        "head": {
            "cond_proj": cm.dense_init(init, d, d),
            "fc1": cm.dense_init(init, adim + d, 2 * d),
            "fc2": cm.dense_init(init, 2 * d, 2 * d),
            "out": cm.dense_init(init, 2 * d, adim),
        },
    }
    if cfg.use_proprio:
        params["proprio_proj"] = cm.dense_init(init, cfg.proprio_dim, d)
    return params


def init(cfg: OctoConfig, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    return init_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


# ---------------------------------------------------------------------------
# mask template
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _mask_template(lt: int, per_frame: int, history: int) -> np.ndarray:
    """Static [N, N] bool attention template (see the module docstring)."""
    n = lt + history * (per_frame + 1)
    m = np.zeros((n, n), bool)
    m[:lt, :lt] = True  # task <-> task

    def obs_slice(t):
        start = lt + t * (per_frame + 1)
        return slice(start, start + per_frame)

    for t in range(history):
        rows = obs_slice(t)
        r = lt + t * (per_frame + 1) + per_frame  # readout_t
        m[rows, :lt] = True
        m[r, :lt] = True
        for t2 in range(t + 1):
            m[rows, obs_slice(t2)] = True
            m[r, obs_slice(t2)] = True
        m[r, r] = True
    return m


def block_mask(lang_masks: torch.Tensor, img_masks: torch.Tensor, per_frame: int) -> torch.Tensor:
    """The template of the block layout & the keys' padding -> bool [B, N, N]."""
    lt, history = lang_masks.shape[1], img_masks.shape[1]
    template = torch.from_numpy(_mask_template(lt, per_frame, history)).to(lang_masks.device)
    frame_pad = torch.repeat_interleave(img_masks.bool(), per_frame + 1, dim=1)
    pad = torch.cat([lang_masks.bool(), frame_pad], dim=1)  # [B, N]
    return template[None] & pad[:, None, :]


def transformer(blocks: cm.Params, tokens: torch.Tensor, mask: torch.Tensor, num_heads: int, eps: float,
                policy: DtypePolicy) -> torch.Tensor:
    """Pre-norm ViT blocks (stacked) over tokens [B, N, D] under a bool mask
    [B, N, N], plain attention."""
    b, n, d = tokens.shape
    hd = d // num_heads
    x = tokens
    for i in range(blocks["ln1"]["scale"].shape[0]):
        bp = cm.layer(blocks, i)
        y = cm.layer_norm(bp["ln1"], x, eps)
        q = cm.dense(bp["attn"]["q"], y, policy).reshape(b, n, num_heads, hd)
        k = cm.dense(bp["attn"]["k"], y, policy).reshape(b, n, num_heads, hd)
        v = cm.dense(bp["attn"]["v"], y, policy).reshape(b, n, num_heads, hd)
        att = multi_head_attention(q, k, v, mask=mask)
        x = x + cm.dense(bp["attn"]["o"], att.reshape(b, n, d), policy)
        x = x + cm.gelu_mlp(bp["mlp"], cm.layer_norm(bp["ln2"], x, eps), policy)
    return x


# ---------------------------------------------------------------------------
# transformer forward
# ---------------------------------------------------------------------------

def encode(params, images, img_masks, lang_tokens, lang_masks, cfg: OctoConfig,
           policy: DtypePolicy = DEFAULT_POLICY, proprio=None) -> torch.Tensor:
    """-> readout embeddings [B, history, width] (final-normed).

    images [B, T, H, W, 3] in [-1, 1]; img_masks [B, T] marks real frames."""
    b, t = images.shape[:2]
    g, p = cfg.image_size // cfg.patch_size, cfg.patch_size
    n_patch = g * g
    # patches (row, col)-ordered, each flattened (py, px, channel)
    x = policy.cast(images).reshape(b, t, g, p, g, p, 3).permute(0, 1, 2, 4, 3, 5, 6)
    obs = cm.dense(params["patch_embed"], x.reshape(b, t, n_patch, p * p * 3), policy)
    obs = obs + policy.cast(params["obs_pos_embed"])

    lang = cm.embed_lookup(params["lang_embed"], lang_tokens, policy)
    lt = lang.shape[1]
    readout = policy.cast(params["readout_embed"]).expand(b, cfg.history, cfg.width)

    per_frame = n_patch
    groups = [obs]
    if cfg.use_proprio:
        if proprio is None:
            raise ValueError("use_proprio=True but encode() got proprio=None")
        pp = policy.cast(proprio)
        if pp.ndim == 2:  # the current state only: the same for every frame
            pp = pp[:, None, :].expand(b, t, pp.shape[-1])
        groups.append(cm.dense(params["proprio_proj"], pp, policy)[:, :, None, :])
        per_frame += 1
    groups.append(readout[:, :, None, :])
    frames = torch.cat(groups, dim=2)  # [B, T, per_frame + 1, D]
    tokens = torch.cat([lang, frames.reshape(b, t * (per_frame + 1), cfg.width)], dim=1)

    mask = block_mask(lang_masks, img_masks, per_frame)
    tokens = transformer(params["blocks"], tokens, mask, cfg.num_heads, cfg.norm_eps, policy)
    tokens = cm.layer_norm(params["final_ln"], tokens, cfg.norm_eps)
    readout_idx = lt + torch.arange(cfg.history, device=tokens.device) * (per_frame + 1) + per_frame
    return tokens[:, readout_idx]


# ---------------------------------------------------------------------------
# diffusion action head
# ---------------------------------------------------------------------------

def _eps_fn(params, cfg: OctoConfig, policy: DtypePolicy, x_t, t_int, cond):
    """FiLM-MLP denoiser in fp32: x_t [B, horizon, action_dim], t_int [B],
    cond [B, width]."""
    head = params["head"]
    t_emb = diff.timestep_embedding(t_int, cfg.width)
    c = F.silu(cm.dense(head["cond_proj"], cond.to(torch.float32), FP32_POLICY) + t_emb)
    h = torch.cat([x_t.reshape(x_t.shape[0], -1), c], dim=-1)
    h = F.silu(cm.dense(head["fc1"], h, FP32_POLICY))
    h = F.silu(cm.dense(head["fc2"], h, FP32_POLICY))
    return cm.dense(head["out"], h, FP32_POLICY).reshape(x_t.shape)


# ---------------------------------------------------------------------------
# training and sampling
# ---------------------------------------------------------------------------

def compute_loss(params, rng: np.random.Generator | None, batch: dict, cfg: OctoConfig,
                 policy: DtypePolicy = DEFAULT_POLICY, t_int=None, noise=None):
    """Epsilon-MSE of the head on the last readout -> (loss, {"l2_loss",
    "losses"}); `rng` draws the timesteps and noise that are not given."""
    readouts = encode(params, batch["images"], batch["img_masks"], batch["lang_tokens"], batch["lang_masks"], cfg,
                      policy, proprio=batch.get("state") if cfg.use_proprio else None)
    loss, aux = diff.training_loss(
        diff.make_schedule(cfg.diffusion_steps), lambda x, t, c: _eps_fn(params, cfg, policy, x, t, c),
        rng, batch["actions"].to(torch.float32), readouts[:, -1], t_int=t_int, noise=noise)
    return loss, {"l2_loss": loss, "losses": aux["losses"]}


def sample_actions(params, generator, images, img_masks, lang_tokens, lang_masks, state, cfg: OctoConfig,
                   policy: DtypePolicy = DEFAULT_POLICY, noise=None, step_noise=None):
    """-> actions [B, horizon, action_dim] fp32. `noise` fixes x_T;
    `step_noise` gives DDPM's per-step draws (replaying another sampler's)."""
    readouts = encode(params, images, img_masks, lang_tokens, lang_masks, cfg, policy,
                      proprio=state if cfg.use_proprio else None)
    schedule = diff.make_schedule(cfg.diffusion_steps)
    shape = (images.shape[0], cfg.horizon, cfg.action_dim)

    def eps_fn(x, t, c):
        return _eps_fn(params, cfg, policy, x, t, c)

    if cfg.sample_steps >= cfg.diffusion_steps:
        return diff.ddpm_sample(schedule, eps_fn, generator, shape, readouts[:, -1], init_noise=noise,
                                step_noise=step_noise)
    return diff.ddim_sample(schedule, eps_fn, generator, shape, readouts[:, -1], num_steps=cfg.sample_steps,
                            init_noise=noise)
