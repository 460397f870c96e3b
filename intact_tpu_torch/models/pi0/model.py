"""Pi0 flow-matching core: embed, training loss, Euler sampler.

  t ~ Beta(1.5, 1) * 0.999 + 0.001           (sample_time)
  x_t = t * noise + (1 - t) * actions        (noisy action interpolation)
  u_t = noise - actions                      (flow target)
  loss = mse(u_t, v_t)                       (masked by action padding)
  inference: x' = x + dt * v_t, dt = -1/num_steps, t: 1 -> 0  (Euler)

The prefix K/V cache is computed once by `gemma.prefill(kv_only=True)`, then
each Euler step runs the action expert through `gemma.decode` against it.

Input convention (tensors on one device, batch-leading):
  images      [B, K, H, W, 3] float in [-1, 1]  (K = num_cameras)
  img_masks   [B, K] bool
  lang_tokens [B, L] int, lang_masks [B, L] bool
  state       [B, max_state_dim] float
  actions     [B, chunk_size, max_action_dim] float (training only)

Training draws its noise and time on the host from an explicit
`numpy.random.Generator` (torch's beta sampler takes no generator); callers
may pass both instead, as the tests do with the reference's draws.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models import gemma, siglip
from intact_tpu_torch.models.common import DEFAULT_POLICY, FP32_POLICY, DtypePolicy
from intact_tpu_torch.models.pi0.config import Pi0Config
from intact_tpu_torch.ops.masks import make_att_2d_masks


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(init: cm.Initializer, cfg: Pi0Config) -> cm.Params:
    pw = cfg.proj_width
    return {
        "siglip": siglip.init_params(init, cfg.vision),
        "img_proj": cm.dense_init(init, cfg.vision.width, cfg.vlm.width),
        "vlm_embed": gemma.init_embed_params(init, cfg.vlm),
        "vlm": gemma.init_blocks_params(init, cfg.vlm),
        "expert": gemma.init_blocks_params(init, cfg.expert),
        "state_proj": cm.dense_init(init, cfg.max_state_dim, pw),
        "action_in_proj": cm.dense_init(init, cfg.max_action_dim, pw),
        "time_mlp_in": cm.dense_init(init, 2 * pw, pw),
        "time_mlp_out": cm.dense_init(init, pw, pw),
        "action_out_proj": cm.dense_init(init, pw, cfg.max_action_dim),
    }


def init(cfg: Pi0Config, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    """Random parameters from a generator seeded with `seed`, made on the
    device (CUDA unless `device` says otherwise) directly in `dtype`."""
    return init_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

def embed_prefix(params, images, img_masks, lang_tokens, lang_masks, cfg: Pi0Config,
                 policy: DtypePolicy = DEFAULT_POLICY):
    """-> (embs [B, P, D_vlm], pad [B, P] bool, att [B, P] int).

    Language embeddings are scaled by sqrt(width) in the compute dtype
    (Gemma convention). Image embeddings are NOT scaled: the reference's
    sqrt(d) multiply cancels PaliGemma's projector-output division, so the
    net prefix image embedding is the raw projector output. The whole prefix
    is one full-attention block (att = 0 everywhere).
    """
    b, k = images.shape[:2]
    n_patch = cfg.vision.num_patches

    patches = siglip.encode(
        params["siglip"], images.reshape(b * k, *images.shape[2:]), cfg.vision, policy
    )
    img_emb = cm.dense(params["img_proj"], patches, policy)
    img_emb = img_emb.reshape(b, k * n_patch, cfg.vlm.width)
    img_pad = img_masks.to(torch.bool).repeat_interleave(n_patch, dim=1)

    lang_emb = cm.embed_lookup(params["vlm_embed"], lang_tokens, policy)
    lang_emb = lang_emb * torch.tensor(cfg.vlm.width**0.5, dtype=lang_emb.dtype, device=lang_emb.device)

    embs = torch.cat([img_emb, lang_emb], dim=1)
    pad = torch.cat([img_pad, lang_masks.to(torch.bool)], dim=1)
    att = torch.zeros(embs.shape[:2], dtype=torch.int32, device=embs.device)
    return embs, pad, att


def suffix_layout(b: int, cfg: Pi0Config, device):
    """(pad, att) of the suffix: token 0 is the state and starts a new block
    (the prefix must not attend to it); tokens 1..chunk are the action chunk,
    one block of its own."""
    pad = torch.ones((b, 1 + cfg.chunk_size), dtype=torch.bool, device=device)
    att = torch.zeros((b, 1 + cfg.chunk_size), dtype=torch.int32, device=device)
    att[:, :2] = 1
    return pad, att


def embed_suffix(params, state, noisy_actions, timestep, cfg: Pi0Config,
                 policy: DtypePolicy = DEFAULT_POLICY):
    """-> (embs [B, 1+chunk, D_exp], pad, att): the projected state, then
    action+time fusion through the swish MLP."""
    state_emb = cm.dense(params["state_proj"], policy.cast(state), policy)[:, None, :]

    time_emb = cm.sinusoidal_embedding(
        timestep, cfg.proj_width, cfg.time_min_period, cfg.time_max_period
    ).to(state_emb.dtype)

    action_emb = cm.dense(params["action_in_proj"], policy.cast(noisy_actions), policy)
    time_tiled = time_emb[:, None, :].expand(action_emb.shape)
    fused = torch.cat([action_emb, time_tiled], dim=-1)
    fused = cm.dense(params["time_mlp_in"], fused, policy)
    fused = F.silu(fused)
    fused = cm.dense(params["time_mlp_out"], fused, policy)

    embs = torch.cat([state_emb, fused], dim=1)
    pad, att = suffix_layout(state.shape[0], cfg, state.device)
    return embs, pad, att


def sample_noise(generator: torch.Generator | None, shape, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)


def sample_time(rng: np.random.Generator, bsize: int, cfg: Pi0Config, device=None) -> torch.Tensor:
    """Flow-matching time [B] (fp32): Beta(alpha, beta) * scale + offset,
    drawn on the host from `rng`."""
    t = rng.beta(cfg.time_beta_alpha, cfg.time_beta_beta, size=bsize).astype(np.float32)
    t = t * np.float32(cfg.time_scale) + np.float32(cfg.time_offset)
    return torch.from_numpy(t).to(device)


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def compute_loss(params, rng: np.random.Generator | None, batch: dict, cfg: Pi0Config,
                 policy: DtypePolicy = DEFAULT_POLICY, train: bool = True,
                 noise: torch.Tensor | None = None, time: torch.Tensor | None = None):
    """-> (mean loss, {"l2_loss": mean loss, "losses": [B, chunk, action_dim]}).

    batch keys: images, img_masks, lang_tokens, lang_masks, state, actions,
    and optionally action_is_pad [B, chunk] bool. `rng` draws the noise and
    the time unless both are given. With `train` and cfg.train_expert_only
    the velocity comes from the frozen-prefix path.
    """
    actions = batch["actions"].to(torch.float32)
    device = actions.device
    if noise is None:
        noise = torch.from_numpy(rng.standard_normal(tuple(actions.shape), dtype=np.float32)).to(device)
    if time is None:
        time = sample_time(rng, actions.shape[0], cfg, device)

    t = time[:, None, None]
    x_t = t * noise + (1 - t) * actions
    u_t = noise - actions

    predict = predict_velocity_frozen_prefix if (train and cfg.train_expert_only) else predict_velocity
    v_t = predict(
        params, batch["images"], batch["img_masks"], batch["lang_tokens"],
        batch["lang_masks"], batch["state"], x_t, time, cfg, policy,
    )
    losses = torch.square(u_t - v_t)
    if "action_is_pad" in batch:
        keep = ~batch["action_is_pad"]  # [B, chunk]
        losses = losses * keep[:, :, None].to(losses.dtype)
        denom = (keep.sum() * cfg.max_action_dim).clamp_min(1)
        mean_loss = losses.sum() / denom
    else:
        mean_loss = losses.mean()
    return mean_loss, {"l2_loss": mean_loss, "losses": losses}


def flow_masks(pre_pad: torch.Tensor, cfg: Pi0Config):
    """The joint pass's layout for a prefix pad mask [B, P]: (mask_2d
    [B, P+S, P+S], positions [B, P+S])."""
    suf_pad, suf_att = suffix_layout(pre_pad.shape[0], cfg, pre_pad.device)
    pad = torch.cat([pre_pad, suf_pad], dim=1)
    att = torch.cat([torch.zeros_like(pre_pad, dtype=torch.int32), suf_att], dim=1)
    return make_att_2d_masks(pad, att), torch.cumsum(pad.to(torch.int32), dim=1) - 1


def predict_velocity(params, images, img_masks, lang_tokens, lang_masks, state,
                     x_t, time, cfg: Pi0Config, policy: DtypePolicy = DEFAULT_POLICY):
    """Single joint prefix+suffix pass -> v_t [B, chunk, action_dim] (fp32)."""
    pre_embs, pre_pad, _ = embed_prefix(params, images, img_masks, lang_tokens, lang_masks, cfg, policy)
    suf_embs, _, _ = embed_suffix(params, state, x_t, time, cfg, policy)
    mask_2d, positions = flow_masks(pre_pad, cfg)
    _, suffix_out = gemma.forward_joint(
        params["vlm"], params["expert"], pre_embs, suf_embs, mask_2d, positions,
        cfg.vlm, cfg.expert, policy, cfg.attention_impl,
        suffix_only=True,  # skip the last layer's dead prefix tail
    )
    suffix_out = suffix_out[:, -cfg.chunk_size:].to(torch.float32)
    return cm.dense(params["action_out_proj"], suffix_out, FP32_POLICY)  # fp32 action head


def prefix_cache(params, images, img_masks, lang_tokens, lang_masks, cfg: Pi0Config,
                 policy: DtypePolicy = DEFAULT_POLICY):
    """The prefix through SigLIP, the projector and `gemma.prefill(kv_only=True)`
    -> (kv_cache, pre_pad). The caller chooses the grad mode: the sampler
    runs it under inference_mode, the frozen-prefix training path under
    no_grad."""
    pre_embs, pre_pad, pre_att = embed_prefix(params, images, img_masks, lang_tokens, lang_masks, cfg, policy)
    pre_mask = make_att_2d_masks(pre_pad, pre_att)
    pre_pos = torch.cumsum(pre_pad.to(torch.int32), dim=1) - 1
    _, kv_cache = gemma.prefill(
        params["vlm"], pre_embs, pre_mask, pre_pos, cfg.vlm, policy, cfg.attention_impl, kv_only=True,
    )
    return kv_cache, pre_pad


def decode_layout(pre_pad: torch.Tensor, cfg: Pi0Config):
    """The suffix's decode mask [B, S, P+S] against [prefix cache; suffix]
    and its positions [B, S], continuing after the prefix."""
    b = pre_pad.shape[0]
    prefix_count = pre_pad.sum(dim=1, keepdim=True).to(torch.int32)  # [B, 1]
    suf_pad, suf_att = suffix_layout(b, cfg, pre_pad.device)
    suf_self = make_att_2d_masks(suf_pad, suf_att)  # [B, S, S]
    suf_to_pre = pre_pad[:, None, :].expand(b, suf_pad.shape[1], pre_pad.shape[1])
    dec_mask = torch.cat([suf_to_pre, suf_self], dim=2)
    suf_pos = prefix_count + torch.cumsum(suf_pad.to(torch.int32), dim=1) - 1
    return dec_mask, suf_pos


def predict_velocity_frozen_prefix(params, images, img_masks, lang_tokens, lang_masks, state, x_t, time,
                                   cfg: Pi0Config, policy: DtypePolicy = DEFAULT_POLICY):
    """Expert-only fine-tune path -> v_t [B, chunk, action_dim] (fp32). The
    prefix tower (SigLIP, projector, VLM) is frozen, so it runs forward-only
    under no_grad and its K/V cache carries no graph; the expert then runs
    `gemma.decode` against that cache with autograd. The expert and head
    gradients equal the joint path's: every gradient path through the prefix
    K/V leads to frozen parameters only. The prefix's int8 products (a
    `quantize_frozen` tower) have no gradient, and need none here."""
    with torch.no_grad():
        kv_cache, pre_pad = prefix_cache(params, images, img_masks, lang_tokens, lang_masks, cfg, policy)
    dec_mask, suf_pos = decode_layout(pre_pad, cfg)
    suf_embs, _, _ = embed_suffix(params, state, x_t, time, cfg, policy)
    suffix_out = gemma.decode(params["expert"], kv_cache, suf_embs, dec_mask, suf_pos, cfg.expert, policy,
                              cfg.attention_impl)
    suffix_out = suffix_out[:, -cfg.chunk_size:].to(torch.float32)
    return cm.dense(params["action_out_proj"], suffix_out, FP32_POLICY)  # fp32 action head


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

@torch.inference_mode()
def sample_actions(params, generator, images, img_masks, lang_tokens, lang_masks, state,
                   cfg: Pi0Config, policy: DtypePolicy = DEFAULT_POLICY,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """One prefill + num_steps Euler steps.

    `generator` draws the initial noise unless `noise` is given.
    Returns [B, chunk_size, max_action_dim] float32.
    """
    b, device = state.shape[0], state.device
    if noise is None:
        noise = sample_noise(generator, (b, cfg.chunk_size, cfg.max_action_dim), device)

    kv_cache, pre_pad = prefix_cache(params, images, img_masks, lang_tokens, lang_masks, cfg, policy)
    # the suffix attention layout is timestep-independent: build it once
    dec_mask, suf_pos = decode_layout(pre_pad, cfg)

    dt = -1.0 / cfg.num_steps
    # t goes 1.0, 1-1/N, ..., 1/N  (num_steps steps down to 0)
    ts = 1.0 + dt * torch.arange(cfg.num_steps, dtype=torch.float32, device=device)
    x_t = noise.to(torch.float32)
    for i in range(cfg.num_steps):
        time = ts[i].expand(b)
        suf_embs, _, _ = embed_suffix(params, state, x_t, time, cfg, policy)
        suffix_out = gemma.decode(
            params["expert"], kv_cache, suf_embs, dec_mask, suf_pos,
            cfg.expert, policy, cfg.attention_impl,
        )
        suffix_out = suffix_out[:, -cfg.chunk_size:].to(torch.float32)
        v_t = cm.dense(params["action_out_proj"], suffix_out, FP32_POLICY)  # fp32 action head
        x_t = x_t + dt * v_t
    return x_t
