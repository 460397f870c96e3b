"""Octo configuration (intact_tpu/models/octo/config.py), field for field.

The native Octo: a block-attention transformer over [task, obs_1,
readout_1, ..., obs_T, readout_T] tokens and a FiLM-MLP diffusion head;
language is the framework tokenizer's ids through a learned table (the
released architecture's T5 encoder is `upstream.py`'s).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OctoConfig:
    # transformer (octo-small operating point)
    width: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_dim: int = 1536

    # observations
    image_size: int = 256
    patch_size: int = 16
    history: int = 2  # n_obs_steps
    use_proprio: bool = False
    proprio_dim: int = 7

    # language
    vocab_size: int = 32_000
    max_lang_tokens: int = 16

    # diffusion action head
    action_dim: int = 7
    horizon: int = 4
    diffusion_steps: int = 20
    sample_steps: int = 20  # DDPM over every step by default

    norm_eps: float = 1e-6

    @property
    def tokens_per_frame(self) -> int:
        n = (self.image_size // self.patch_size) ** 2
        return n + (1 if self.use_proprio else 0)

    # the names the pi0-shaped plumbing reads
    @property
    def tokenizer_max_length(self) -> int:
        return self.max_lang_tokens

    @property
    def max_state_dim(self) -> int:
        return self.proprio_dim

    @property
    def max_action_dim(self) -> int:
        return self.action_dim

    @property
    def chunk_size(self) -> int:
        return self.horizon

    @property
    def n_action_steps(self) -> int:
        return self.horizon

    @property
    def num_cameras(self) -> int:
        return self.history

    @staticmethod
    def small() -> "OctoConfig":
        return OctoConfig()

    @staticmethod
    def base() -> "OctoConfig":
        return OctoConfig(width=768, depth=12, num_heads=12, mlp_dim=3072)

    @staticmethod
    def tiny() -> "OctoConfig":
        return OctoConfig(
            width=32, depth=2, num_heads=2, mlp_dim=64,
            image_size=32, patch_size=16, history=2,
            vocab_size=256, max_lang_tokens=8,
            diffusion_steps=8, sample_steps=8,
        )
