"""DreamVLA (experimental): a world-model VLA (intact_tpu/models/dreamvla.py).

  frame -> SigLIP patch encoder -> Perceiver resampler (learned latents
  cross-attend the patches) -> frame-causal transformer over per-timestep
  [obs latents | readout] blocks (Octo's block layout) -> heads: the action
  chunk, the next frame's latents (the world-model loss) and three
  auxiliary "dream" heads (dynamic region, depth, semantic), each loss
  taken only when its target is in the batch.

Research use only, as in the reference: no registry type and no serving
wrapper. Attention is the plain path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models import siglip
from intact_tpu_torch.models.common import DEFAULT_POLICY, FP32_POLICY, DtypePolicy
from intact_tpu_torch.models.octo.model import block_init, transformer
from intact_tpu_torch.models.siglip import SigLIPConfig
from intact_tpu_torch.ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class DreamVLAConfig:
    vision: SigLIPConfig = dataclasses.field(
        default_factory=lambda: SigLIPConfig(image_size=224, patch_size=14, width=384, depth=6, mlp_dim=1536,
                                             num_heads=6)
    )
    num_latents: int = 16      # perceiver resampler output tokens per frame
    width: int = 384
    depth: int = 8
    num_heads: int = 6
    mlp_dim: int = 1536
    history: int = 2
    action_dim: int = 7
    horizon: int = 4
    world_loss_weight: float = 0.5
    norm_eps: float = 1e-6
    # the auxiliary "dream" heads: each loss is taken only when the batch
    # carries its target
    dynamic_loss_weight: float = 0.1   # target "dynamic_mask" [B,T,G,G]
    depth_loss_weight: float = 0.1     # target "depth" [B,T,G,G]
    semantic_dim: int = 32             # target "semantic" [B,T,L,semantic_dim]
    semantic_loss_weight: float = 0.1

    @staticmethod
    def tiny() -> "DreamVLAConfig":
        return DreamVLAConfig(
            vision=SigLIPConfig(image_size=28, patch_size=14, width=32, depth=2, mlp_dim=64, num_heads=2),
            num_latents=4, width=32, depth=2, num_heads=2, mlp_dim=64,
        )


def init_params(init: cm.Initializer, cfg: DreamVLAConfig) -> cm.Params:
    d, g2 = cfg.width, cfg.vision.grid ** 2
    return {
        "vit": siglip.init_params(init, cfg.vision),
        "vit_proj": cm.dense_init(init, cfg.vision.width, d),
        "latents": init.normal((1, cfg.num_latents, d), 0.02),
        "resampler": {name: cm.dense_init(init, d, d) for name in ("q", "k", "v", "o")},
        "readout": init.normal((1, 1, d), 0.02),
        "blocks": block_init(init, d, cfg.mlp_dim, cfg.depth),
        "final_ln": cm.layernorm_init(init, d),
        "heads": {
            "action": cm.dense_init(init, d, cfg.horizon * cfg.action_dim),
            "world": cm.dense_init(init, d, cfg.num_latents * d),
            # per-patch auxiliary predictions over the vision grid
            "dynamic": cm.dense_init(init, d, g2),
            "depth": cm.dense_init(init, d, g2),
            "semantic": cm.dense_init(init, d, cfg.num_latents * cfg.semantic_dim),
        },
    }


def init(cfg: DreamVLAConfig, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    return init_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


def _resample(params, patches: torch.Tensor, cfg: DreamVLAConfig, policy: DtypePolicy) -> torch.Tensor:
    """Perceiver: the learned latents cross-attend the patch tokens."""
    b = patches.shape[0]
    d, h = cfg.width, cfg.num_heads
    hd = d // h
    lat = policy.cast(params["latents"]).expand(b, cfg.num_latents, d)
    q = cm.dense(params["resampler"]["q"], lat, policy).reshape(b, cfg.num_latents, h, hd)
    k = cm.dense(params["resampler"]["k"], patches, policy).reshape(b, -1, h, hd)
    v = cm.dense(params["resampler"]["v"], patches, policy).reshape(b, -1, h, hd)
    att = multi_head_attention(q, k, v, mask=None)
    return lat + cm.dense(params["resampler"]["o"], att.reshape(b, cfg.num_latents, d), policy)


def _frame_latents(params, images: torch.Tensor, cfg: DreamVLAConfig, policy: DtypePolicy) -> torch.Tensor:
    """[B, T, H, W, 3] -> [B, T, num_latents, width]."""
    b, t = images.shape[:2]
    patches = siglip.encode(params["vit"], images.reshape(b * t, *images.shape[2:]), cfg.vision, policy)
    lat = _resample(params, cm.dense(params["vit_proj"], patches, policy), cfg, policy)
    return lat.reshape(b, t, cfg.num_latents, cfg.width)


def _block_causal_mask(t: int, per_frame: int) -> np.ndarray:
    """Frame-level causal: tokens of frame i attend frames <= i."""
    frame_of = np.arange(t * per_frame) // per_frame
    return frame_of[None, :] <= frame_of[:, None]


def forward(params, images: torch.Tensor, cfg: DreamVLAConfig, policy: DtypePolicy = DEFAULT_POLICY):
    """images [B, T, H, W, 3] in [-1, 1] -> (the action chunk [B, horizon,
    action_dim], the frames' latents [B, T, L, D], the predicted next-frame
    latents [B, T, L, D], {"dynamic", "depth", "semantic"} predictions);
    heads in fp32."""
    b, t = images.shape[:2]
    d = cfg.width
    lat = _frame_latents(params, images, cfg, policy)  # [B, T, L, D]
    readout = policy.cast(params["readout"]).expand(b, t, d)[:, :, None, :]
    per_frame = cfg.num_latents + 1
    tokens = torch.cat([lat, readout], dim=2).reshape(b, t * per_frame, d)

    mask = torch.from_numpy(_block_causal_mask(t, per_frame)).to(tokens.device)[None]
    tokens = transformer(params["blocks"], tokens, mask, cfg.num_heads, cfg.norm_eps, policy)
    tokens = cm.layer_norm(params["final_ln"], tokens, cfg.norm_eps).reshape(b, t, per_frame, d)

    ro32 = tokens[:, :, -1].to(torch.float32)  # the readouts [B, T, D]
    heads = params["heads"]
    actions = cm.dense(heads["action"], ro32[:, -1], FP32_POLICY).reshape(b, cfg.horizon, cfg.action_dim)
    pred_next = cm.dense(heads["world"], ro32, FP32_POLICY).reshape(b, t, cfg.num_latents, d)
    g = cfg.vision.grid
    aux = {
        "dynamic": cm.dense(heads["dynamic"], ro32, FP32_POLICY).reshape(b, t, g, g),
        "depth": cm.dense(heads["depth"], ro32, FP32_POLICY).reshape(b, t, g, g),
        "semantic": cm.dense(heads["semantic"], ro32, FP32_POLICY).reshape(b, t, cfg.num_latents, cfg.semantic_dim),
    }
    return actions, lat, pred_next, aux


def compute_loss(params, rng, batch: dict, cfg: DreamVLAConfig, policy: DtypePolicy = DEFAULT_POLICY):
    """Action MSE + the world-model loss (frame t's prediction against the
    detached latents of frame t + 1) + the auxiliary losses whose targets the
    batch carries (dynamic-region BCE, depth MSE, semantic-feature MSE) ->
    (loss, metrics). Draws nothing: `rng` is unused."""
    del rng
    actions_pred, lat, pred_next, aux_pred = forward(params, batch["images"], cfg, policy)
    gt = batch["actions"][:, :cfg.horizon, :cfg.action_dim].to(torch.float32)
    action_loss = torch.square(actions_pred - gt).mean()
    # with one frame there is nothing to predict: the mean over an empty
    # slice would be NaN
    if lat.shape[1] > 1:
        target = lat[:, 1:].to(torch.float32).detach()
        world_loss = torch.square(pred_next[:, :-1].to(torch.float32) - target).mean()
    else:
        world_loss = torch.zeros((), dtype=torch.float32, device=actions_pred.device)

    loss = action_loss + cfg.world_loss_weight * world_loss
    metrics = {"action_loss": action_loss, "world_loss": world_loss}
    if "dynamic_mask" in batch:  # [B, T, G, G] in {0, 1}
        tgt = batch["dynamic_mask"].to(torch.float32)
        logits = aux_pred["dynamic"]
        bce = (torch.clamp(logits, min=0) - logits * tgt + torch.log1p(torch.exp(-logits.abs()))).mean()
        loss = loss + cfg.dynamic_loss_weight * bce
        metrics["dynamic_loss"] = bce
    if "depth" in batch:  # [B, T, G, G] depth at patch resolution
        dl = torch.square(aux_pred["depth"] - batch["depth"].to(torch.float32)).mean()
        loss = loss + cfg.depth_loss_weight * dl
        metrics["depth_loss"] = dl
    if "semantic" in batch:  # [B, T, L, semantic_dim]
        sl = torch.square(aux_pred["semantic"] - batch["semantic"].to(torch.float32)).mean()
        loss = loss + cfg.semantic_loss_weight * sl
        metrics["semantic_loss"] = sl
    return loss, {"l2_loss": loss, **metrics}
