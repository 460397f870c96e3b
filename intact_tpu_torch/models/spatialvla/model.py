"""Native SpatialVLA: SigLIP + Ego3D position encoding + Gemma2 spatial-token
decode (intact_tpu/models/spatialvla/model.py).

One inference: SigLIP encodes the image, the Ego3D encoding of the
back-projected patch centers is added, the projector maps the patches into
the LM width, and Gemma2 prefills [image | language] as one bidirectional
prefix (the PaliGemma2 prefix-LM convention), then greedily decodes
3 * n_action_steps spatial-grid tokens against its K/V cache
(models/gemma2.greedy_decode). Tokens become continuous actions on the host
(serve/decoding.SpatialActionTokenizer).

Depth: upstream estimates it with ZoeDepth, an external asset not
reimplemented here; `depth` is an input (the client's, or the flat-plane
prior of `flat_depth`).

Weight import reads the HF SpatialVLA/PaliGemma2 layout (`vision_tower`
SiglipVisionModel naming, `multi_modal_projector`, `language_model` Gemma2
naming, the `position_embedding_3d` MLP), held against the meta-device init.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models import gemma2, siglip
from intact_tpu_torch.models.common import DEFAULT_POLICY, DtypePolicy
from intact_tpu_torch.models.spatialvla.config import SpatialVLAConfig


def init_params(init: cm.Initializer, cfg: SpatialVLAConfig) -> cm.Params:
    feat_dim = 6 * cfg.ego3d_n_freqs  # sin and cos per (x, y, z) frequency
    return {
        "siglip": siglip.init_params(init, cfg.vision),
        "ego3d": {
            "linear_1": cm.dense_init(init, feat_dim, cfg.ego3d_hidden),
            "linear_2": cm.dense_init(init, cfg.ego3d_hidden, cfg.vision.width),
        },
        "img_proj": cm.dense_init(init, cfg.vision.width, cfg.lm.width),
        "lm": gemma2.init_params(init, cfg.lm),
    }


def init(cfg: SpatialVLAConfig, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    """Random parameters from a generator seeded with `seed`, made on the
    device (CUDA unless `device` says otherwise) directly in `dtype`."""
    return init_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


# ---------------------------------------------------------------------------
# Ego3D position encoding
# ---------------------------------------------------------------------------

def flat_depth(batch: int, cfg: SpatialVLAConfig, z: float = 1.0) -> np.ndarray:
    """Flat-plane depth prior at the patch resolution [B, g, g]."""
    g = cfg.vision.grid
    return np.full((batch, g, g), z, np.float32)


def ego3d_position_encoding(params, depth: torch.Tensor, cfg: SpatialVLAConfig,
                            policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """depth [B, g, g] (meters at the patch resolution) -> [B, n_patch, width].

    Back-projects the patch centers through the normalized pinhole
    intrinsics to egocentric 3D points, encodes each coordinate at
    `ego3d_n_freqs` frequencies 2^f (sin, cos), and maps the features
    through the 2-layer MLP (exact GELU)."""
    b, g = depth.shape[0], cfg.vision.grid
    u = (torch.arange(g, dtype=torch.float32, device=depth.device) + 0.5) / g  # patch-center pixel coords
    uu, vv = torch.meshgrid(u, u, indexing="xy")  # [g, g] (row = v, col = u)
    z = depth.to(torch.float32).reshape(b, g, g)
    x = (uu[None] - cfg.cx) / cfg.fx * z
    y = (vv[None] - cfg.cy) / cfg.fy * z
    pts = torch.stack([x, y, z], dim=-1).reshape(b, g * g, 3)
    freqs = 2.0 ** torch.arange(cfg.ego3d_n_freqs, dtype=torch.float32, device=depth.device)
    ang = pts[..., None] * freqs  # [B, N, 3, F]
    feat = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(b, g * g, 6 * cfg.ego3d_n_freqs)
    h = cm.dense(params["ego3d"]["linear_1"], policy.cast(feat), policy)
    return cm.dense(params["ego3d"]["linear_2"], F.gelu(h, approximate="none"), policy)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> [-1, 1] fp32, on the device (serving ships uint8
    frames: 4x fewer bytes to the card)."""
    return images_u8.to(torch.float32) * (2.0 / 255.0) - 1.0


def embed_prefix(params, images, depth, lang_tokens, lang_masks, cfg: SpatialVLAConfig,
                 policy: DtypePolicy = DEFAULT_POLICY):
    """-> (embeds [B, N + L, D], mask bool [B, N + L]). The image embeddings
    are the projector's output as is; the language embeddings carry the
    Gemma sqrt(width) scale in the compute dtype."""
    patches = siglip.encode(params["siglip"], images, cfg.vision, policy)
    patches = patches + ego3d_position_encoding(params, depth, cfg, policy)
    img_emb = cm.dense(params["img_proj"], patches, policy)
    lang_emb = gemma2.embed_tokens(params["lm"], lang_tokens, cfg.lm, policy)
    b, n = img_emb.shape[:2]
    mask = torch.cat([torch.ones((b, n), dtype=torch.bool, device=img_emb.device), lang_masks.to(torch.bool)], dim=1)
    return torch.cat([img_emb, lang_emb], dim=1), mask


@torch.inference_mode()
def predict_action_tokens(params, images, depth, lang_tokens, lang_masks, cfg: SpatialVLAConfig,
                          policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """-> [B, 3 * n_action_steps] spatial token ids (greedy)."""
    embeds, mask = embed_prefix(params, images, depth, lang_tokens, lang_masks, cfg, policy)
    return gemma2.greedy_decode(params["lm"], embeds, mask, cfg.tokens_per_action * cfg.n_action_steps, cfg.lm,
                                policy, prefix_full_attention=True)


def make_action_tokenizer(cfg: SpatialVLAConfig):
    from intact_tpu_torch.serve.decoding import SpatialActionTokenizer

    return SpatialActionTokenizer(
        spatial_offset=cfg.spatial_offset, n_theta=cfg.n_theta, n_phi=cfg.n_phi, n_r=cfg.n_r, n_roll=cfg.n_roll,
        n_pitch=cfg.n_pitch, n_yaw=cfg.n_yaw, r_sigma=cfg.r_sigma, rot_sigma=cfg.rot_sigma,
    )


# ---------------------------------------------------------------------------
# HF checkpoint -> params
# ---------------------------------------------------------------------------

def from_hf_state_dict(
    sd: dict,
    cfg: SpatialVLAConfig,
    vision_prefix: str = "vision_tower.vision_model",
    projector_prefix: str = "multi_modal_projector.linear",
    lm_prefix: str = "language_model.model",
    ego3d_prefix: str = "position_embedding_3d",
) -> cm.Params:
    """HF SpatialVLA/PaliGemma2 layout -> host parameter tree (CPU tensors in
    the checkpoint's dtype), every leaf's shape held against the init. A
    `model.`-nested layout (found off the vision tower) nests every
    component prefix."""
    from intact_tpu_torch.models.hf_import import check_shapes, mlp2_from_sd, siglip_from_sd, t, tensor

    for nest in ("", "model."):
        cand = nest + vision_prefix
        if any(k.startswith(cand + ".embeddings") for k in sd):
            vision_prefix = cand
            projector_prefix = nest + projector_prefix
            lm_prefix = nest + lm_prefix
            ego3d_prefix = nest + ego3d_prefix
            break
    # transformers >= 4.49 dropped the LM's inner ".model" (language_model.layers)
    if lm_prefix + ".embed_tokens.weight" not in sd:
        alt = lm_prefix.removesuffix(".model")
        if alt + ".embed_tokens.weight" in sd:
            lm_prefix = alt
    # the Ego3D MLP may sit beside the backbone rather than under model.
    if not any(k.startswith(ego3d_prefix + ".") for k in sd):
        alt = ego3d_prefix.removeprefix("model.")
        if any(k.startswith(alt + ".") for k in sd):
            ego3d_prefix = alt
    params: cm.Params = {
        "siglip": siglip_from_sd(sd, cfg.vision, prefix=vision_prefix),
        "img_proj": {"kernel": t(sd[projector_prefix + ".weight"]), "bias": tensor(sd[projector_prefix + ".bias"])},
        "ego3d": mlp2_from_sd(sd, ego3d_prefix, "Ego3D MLP"),
        "lm": gemma2.from_hf_state_dict(sd, cfg.lm, prefix=lm_prefix),
    }
    return check_shapes(params, init(cfg, device="meta"))


def load_spatialvla_checkpoint(path: str, cfg: SpatialVLAConfig) -> cm.Params:
    """An HF snapshot directory (sharded `*.safetensors`) -> host parameter tree."""
    from intact_tpu_torch.models.hf_import import load_safetensors_dir

    return from_hf_state_dict(load_safetensors_dir(path), cfg)
