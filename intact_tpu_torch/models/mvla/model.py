"""MVLA flow-matching core (intact_tpu/models/mvla/model.py).

  SigLIP + language + learned METAQUERY tokens -> the Gemma-2B prefix (the
  metaqueries open their own attention block) -> the metaquery outputs ->
  bidirectional connector -> the expert's PROMPT -> self/cross (or joint)
  expert over the [state, action + time] suffix -> action_out_proj ->
  flow-matching velocity.

The flow math (x_t, u_t, Beta time draws, the Euler loop) and the prefix and
suffix embeddings are Pi0's (models/pi0/model.py), with its draw conventions:
training takes its noise and time from a numpy Generator (or given), the
sampler its noise from a torch.Generator (or given). Sampling computes the
prefix, the connector and the prompt K/V once, then runs num_steps Euler
steps. `action_head="dit"` replaces the expert and the flow head with a DiT
denoiser over the pooled prompt (models/dit.py, models/diffusion.py).

Interface as the other model modules (init / compute_loss / sample_actions),
so the trainer, Pi0Policy and the serving wrapper apply.
"""

from __future__ import annotations

import numpy as np
import torch

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models import connector as connector_lib
from intact_tpu_torch.models import diffusion as diff
from intact_tpu_torch.models import dit as dit_lib
from intact_tpu_torch.models import gemma, siglip
from intact_tpu_torch.models.common import DEFAULT_POLICY, FP32_POLICY, DtypePolicy
from intact_tpu_torch.models.mvla import expert as expert_lib
from intact_tpu_torch.models.mvla.config import MVLAConfig
from intact_tpu_torch.models.pi0 import model as pi0
from intact_tpu_torch.ops.masks import make_att_2d_masks


def dit_config(cfg: MVLAConfig) -> dit_lib.DiTConfig:
    return dit_lib.DiTConfig(width=cfg.dit_width, depth=cfg.dit_depth, num_heads=cfg.dit_heads,
                             action_dim=cfg.max_action_dim, horizon=cfg.chunk_size, cond_dim=cfg.proj_width)


def init_params(init: cm.Initializer, cfg: MVLAConfig) -> cm.Params:
    pw = cfg.proj_width
    params = {
        "siglip": siglip.init_params(init, cfg.vision),
        "img_proj": cm.dense_init(init, cfg.vision.width, cfg.vlm.width),
        "vlm_embed": gemma.init_embed_params(init, cfg.vlm),
        "vlm": gemma.init_blocks_params(init, cfg.vlm),
        "metaquery": init.normal((1, cfg.num_metaqueries, cfg.vlm.width), 0.02),
        "connector": connector_lib.init_params(init, cfg.connector, cfg.vlm.width, pw),
    }
    if cfg.action_head == "dit":
        params["dit"] = dit_lib.init_params(init, dit_config(cfg))
        return params
    params.update({
        "expert": (gemma.init_blocks_params(init, cfg.expert) if cfg.alternate_pattern == "joint"
                   else expert_lib.init_params(init, cfg.expert, prompt_dim=pw)),
        "state_proj": cm.dense_init(init, cfg.max_state_dim, pw),
        "action_in_proj": cm.dense_init(init, cfg.max_action_dim, pw),
        "time_mlp_in": cm.dense_init(init, 2 * pw, pw),
        "time_mlp_out": cm.dense_init(init, pw, pw),
        "action_out_proj": cm.dense_init(init, pw, cfg.max_action_dim),
    })
    return params


def init(cfg: MVLAConfig, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    """Random parameters from a generator seeded with `seed`, made on the
    device (CUDA unless `device` says otherwise) directly in `dtype`."""
    return init_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


# ---------------------------------------------------------------------------
# prefix -> prompt
# ---------------------------------------------------------------------------

def embed_prefix(params, images, img_masks, lang_tokens, lang_masks, cfg: MVLAConfig,
                 policy: DtypePolicy = DEFAULT_POLICY):
    """Pi0's image + language prefix, then the metaqueries as a block of
    their own: they see everything before them, nothing before sees them.
    -> (embs [B, P, D_vlm], pad [B, P], att [B, P])."""
    embs, pad, att = pi0.embed_prefix(params, images, img_masks, lang_tokens, lang_masks, cfg, policy)
    b, n = embs.shape[0], cfg.num_metaqueries
    mq = policy.cast(params["metaquery"]).expand(b, n, cfg.vlm.width)
    mq_att = torch.zeros((b, n), dtype=att.dtype, device=att.device)
    mq_att[:, 0] = 1
    return (torch.cat([embs, mq], dim=1), torch.cat([pad, pad.new_ones((b, n))], dim=1),
            torch.cat([att, mq_att], dim=1))


def compute_prompt(params, images, img_masks, lang_tokens, lang_masks, cfg: MVLAConfig,
                   policy: DtypePolicy = DEFAULT_POLICY, stop_vlm_gradient: bool = False) -> torch.Tensor:
    """The full prefix through `gemma.prefill` -> the last num_metaqueries
    rows -> the connector: the prompt [B, num_metaqueries, proj_width].

    stop_vlm_gradient cuts backprop at the VLM/connector boundary: the
    embedding and the prefill run under no_grad. It is an opt-in for runs
    that also freeze the metaqueries; by default they train through the
    frozen VLM, as in the reference. Without autograd the prefill also
    builds its K/V cache, which nothing here reads (`gemma.prefill` has no
    mode that skips it)."""
    with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_vlm_gradient):
        embs, pad, att = embed_prefix(params, images, img_masks, lang_tokens, lang_masks, cfg, policy)
        mask = make_att_2d_masks(pad, att)
        positions = torch.cumsum(pad.to(torch.int32), dim=1) - 1
        prefix_out, _ = gemma.prefill(params["vlm"], embs, mask, positions, cfg.vlm, policy, cfg.attention_impl)
        mq_out = prefix_out[:, -cfg.num_metaqueries:]
    return connector_lib.apply(params["connector"], mq_out, cfg.connector, policy)


# ---------------------------------------------------------------------------
# the expert
# ---------------------------------------------------------------------------

def predict_velocity(params, prompt, state, x_t, time, cfg: MVLAConfig, policy: DtypePolicy = DEFAULT_POLICY,
                     prompt_kv=None) -> torch.Tensor:
    """The expert over [state, action + time] against the prompt (or its
    cached K/V) -> v_t [B, chunk, action_dim] (fp32 head)."""
    suf_embs, suf_pad, suf_att = pi0.embed_suffix(params, state, x_t, time, cfg, policy)
    if cfg.alternate_pattern == "joint":
        out = expert_lib.forward_joint(params["expert"], suf_embs, prompt, suf_att, cfg.expert, policy,
                                       cfg.attention_impl, prompt_kv=prompt_kv)
    else:
        mask = make_att_2d_masks(suf_pad, suf_att)
        positions = torch.cumsum(suf_pad.to(torch.int32), dim=1) - 1
        out = expert_lib.forward(params["expert"], suf_embs, mask, positions, cfg.expert, prompt=prompt,
                                 prompt_kv=prompt_kv, policy=policy, attention_impl=cfg.attention_impl)
    out = out[:, -cfg.chunk_size:].to(torch.float32)
    return cm.dense(params["action_out_proj"], out, FP32_POLICY)


def _dit_eps_fn(params, cfg: MVLAConfig, policy: DtypePolicy):
    dcfg = dit_config(cfg)
    return lambda x_t, t_int, cond: dit_lib.apply(params["dit"], x_t, t_int, cond, dcfg, policy)


def cache_prompt_kv(params, prompt, cfg: MVLAConfig, policy: DtypePolicy = DEFAULT_POLICY):
    """The prompt's K/V for the sampler, computed once: the prompt never
    attends the suffix, so they are the same at every Euler step."""
    if cfg.alternate_pattern == "joint":
        return expert_lib.prefill_joint_prompt_kv(params["expert"], prompt, cfg.expert, policy, cfg.attention_impl)
    return expert_lib.prefill_prompt_kv(params["expert"], prompt, cfg.expert, policy)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def compute_loss(params, rng: np.random.Generator | None, batch: dict, cfg: MVLAConfig,
                 policy: DtypePolicy = DEFAULT_POLICY, train: bool = True,
                 noise: torch.Tensor | None = None, time: torch.Tensor | None = None):
    """-> (mean loss, {"l2_loss": mean loss, "losses": per element}).

    Flow head: Pi0's flow-matching loss, masked by batch["action_is_pad"]
    when given; `rng` draws the noise and the time unless both are given.
    DiT head: the epsilon loss over DDPM timesteps; `time` then holds the
    integer timesteps [B] and `noise` the epsilon, each drawn from `rng`
    when not given. With `train`, train_expert_only and freeze_metaqueries
    the prompt's backward stops at the connector."""
    stop_vlm = train and cfg.train_expert_only and cfg.freeze_metaqueries
    prompt = compute_prompt(params, batch["images"], batch["img_masks"], batch["lang_tokens"],
                            batch["lang_masks"], cfg, policy, stop_vlm_gradient=stop_vlm)
    actions = batch["actions"].to(torch.float32)
    if cfg.action_head == "dit":
        cond = prompt.mean(dim=1).to(torch.float32)  # pooled metaqueries
        loss, aux = diff.training_loss(diff.make_schedule(cfg.diffusion_steps), _dit_eps_fn(params, cfg, policy),
                                       rng, actions, cond, t_int=time, noise=noise)
        return loss, {"l2_loss": loss, "losses": aux["losses"]}

    device = actions.device
    if noise is None:
        noise = torch.from_numpy(rng.standard_normal(tuple(actions.shape), dtype=np.float32)).to(device)
    if time is None:
        time = pi0.sample_time(rng, actions.shape[0], cfg, device)
    t = time[:, None, None]
    x_t = t * noise + (1 - t) * actions
    u_t = noise - actions
    v_t = predict_velocity(params, prompt, batch["state"], x_t, time, cfg, policy)

    losses = torch.square(u_t - v_t)
    if "action_is_pad" in batch:
        keep = ~batch["action_is_pad"]
        losses = losses * keep[:, :, None].to(losses.dtype)
        mean_loss = losses.sum() / (keep.sum() * cfg.max_action_dim).clamp_min(1)
    else:
        mean_loss = losses.mean()
    return mean_loss, {"l2_loss": mean_loss, "losses": losses}


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

@torch.inference_mode()
def sample_actions(params, generator, images, img_masks, lang_tokens, lang_masks, state,
                   cfg: MVLAConfig, policy: DtypePolicy = DEFAULT_POLICY,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """The prompt once, then num_steps Euler steps of the expert against its
    cached K/V (the DiT head: num_steps DDIM steps from x_T = noise).
    `generator` draws the initial noise unless `noise` is given.
    Returns [B, chunk_size, max_action_dim] float32."""
    b, device = state.shape[0], state.device
    shape = (b, cfg.chunk_size, cfg.max_action_dim)
    if noise is None:
        noise = pi0.sample_noise(generator, shape, device)
    prompt = compute_prompt(params, images, img_masks, lang_tokens, lang_masks, cfg, policy)

    if cfg.action_head == "dit":
        return diff.ddim_sample(diff.make_schedule(cfg.diffusion_steps), _dit_eps_fn(params, cfg, policy), generator,
                                shape, prompt.mean(dim=1).to(torch.float32), num_steps=cfg.num_steps,
                                init_noise=noise)
    kv = cache_prompt_kv(params, prompt, cfg, policy)
    dt = -1.0 / cfg.num_steps
    ts = 1.0 + dt * torch.arange(cfg.num_steps, dtype=torch.float32, device=device)
    x_t = noise.to(torch.float32)
    for i in range(cfg.num_steps):
        v_t = predict_velocity(params, prompt, state, x_t, ts[i].expand(b), cfg, policy, prompt_kv=kv)
        x_t = x_t + dt * v_t
    return x_t
