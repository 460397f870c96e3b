"""SpatialVLA configuration: the reference's fields and defaults, redeclared
(intact_tpu/models/spatialvla/config.py).

A PaliGemma2 backbone (SigLIP So400m + Gemma2-2B) with an Ego3D position
encoding added to the visual features; actions are spatial grid tokens
appended to the vocabulary, three per action step (translation cell,
rotation cell, gripper). The LM's vocab_size includes them; spatial_offset
(vocab_size - n_spatial_tokens) is where they start.
"""

from __future__ import annotations

import dataclasses

from intact_tpu_torch.models.gemma2 import Gemma2Config, gemma2_2b
from intact_tpu_torch.models.gemma2 import tiny_test_config as gemma2_tiny
from intact_tpu_torch.models.siglip import SigLIPConfig, so400m_14_224
from intact_tpu_torch.models.siglip import tiny_test_config as siglip_tiny


@dataclasses.dataclass(frozen=True)
class SpatialVLAConfig:
    vision: SigLIPConfig
    lm: Gemma2Config

    # Ego3D position encoding: sinusoidal features of back-projected patch
    # centers -> 2-layer MLP -> added to the SigLIP features
    ego3d_n_freqs: int = 8
    ego3d_hidden: int = 256
    # normalized pinhole intrinsics (fx fy cx cy in units of the image size)
    fx: float = 1.0
    fy: float = 1.0
    cx: float = 0.5
    cy: float = 0.5

    # adaptive action grids (serve/decoding.SpatialActionTokenizer)
    n_theta: int = 16
    n_phi: int = 8
    n_r: int = 16
    n_roll: int = 8
    n_pitch: int = 8
    n_yaw: int = 8
    r_sigma: float = 1.0
    rot_sigma: float = 1.0

    # the fields the pipeline reads off every model config
    type: str = "spatialvla_native"
    chunk_size: int = 4
    n_action_steps: int = 4
    n_obs_steps: int = 1
    num_cameras: int = 1
    tokenizer_max_length: int = 48
    max_state_dim: int = 7
    max_action_dim: int = 7

    @property
    def n_spatial_tokens(self) -> int:
        return self.n_theta * self.n_phi * self.n_r + self.n_roll * self.n_pitch * self.n_yaw + 2

    @property
    def spatial_offset(self) -> int:
        return self.lm.vocab_size - self.n_spatial_tokens

    @property
    def tokens_per_action(self) -> int:
        return 3

    @classmethod
    def spatialvla_4b(cls) -> "SpatialVLAConfig":
        # the PaliGemma2 vocabulary (257,152) + the appended spatial tokens
        lm = dataclasses.replace(gemma2_2b(), vocab_size=257_152 + 16 * 8 * 16 + 8 * 8 * 8 + 2)
        return cls(vision=so400m_14_224(), lm=lm)

    @classmethod
    def tiny(cls) -> "SpatialVLAConfig":
        """CPU-testable point: a 2x2 patch grid, small grids, a small vocab."""
        grids = dict(n_theta=4, n_phi=2, n_r=4, n_roll=2, n_pitch=2, n_yaw=2)
        n_spatial = 4 * 2 * 4 + 2 * 2 * 2 + 2
        lm = dataclasses.replace(gemma2_tiny(), vocab_size=256 + n_spatial)
        return cls(vision=siglip_tiny(), lm=lm, ego3d_n_freqs=2, ego3d_hidden=16, chunk_size=2, n_action_steps=2,
                   tokenizer_max_length=8, **grids)
