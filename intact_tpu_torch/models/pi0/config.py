"""Pi0 model configuration: the reference's fields and defaults, redeclared.

Field parity with the reference model JSON (pi0_finetune_bridge: chunk_size 4,
n_action_steps 4, max_state_dim/max_action_dim 32, tokenizer_max_length 72,
num_steps 10, proj_width 1024) and the trainer's freeze / attention fields.
"""

from __future__ import annotations

import dataclasses

from intact_tpu_torch.models.gemma import GemmaConfig, gemma_2b, gemma_300m_expert
from intact_tpu_torch.models.gemma import tiny_test_config as gemma_tiny
from intact_tpu_torch.models.siglip import SigLIPConfig, so400m_14_224
from intact_tpu_torch.models.siglip import tiny_test_config as siglip_tiny


@dataclasses.dataclass(frozen=True)
class Pi0Config:
    vision: SigLIPConfig = dataclasses.field(default_factory=so400m_14_224)
    vlm: GemmaConfig = dataclasses.field(default_factory=gemma_2b)
    expert: GemmaConfig = dataclasses.field(default_factory=gemma_300m_expert)

    num_cameras: int = 1
    tokenizer_max_length: int = 72

    max_state_dim: int = 32
    max_action_dim: int = 32
    chunk_size: int = 4  # action horizon predicted per inference
    n_action_steps: int = 4  # actions executed before re-inferring
    num_steps: int = 10  # Euler denoise steps

    # flow-matching time distribution: Beta(1.5, 1) * 0.999 + 0.001
    time_beta_alpha: float = 1.5
    time_beta_beta: float = 1.0
    time_scale: float = 0.999
    time_offset: float = 0.001

    time_min_period: float = 4e-3
    time_max_period: float = 4.0

    # "pallas": the prefix attention runs the hand-written CUDA kernel on the
    # card (its plain version on the CPU); "xla": the plain einsum path
    attention_impl: str = "pallas"

    # freezing (used by training)
    freeze_vision_encoder: bool = False
    freeze_vlm: bool = False
    train_expert_only: bool = False

    @property
    def proj_width(self) -> int:
        return self.expert.width

    @property
    def prefix_len(self) -> int:
        return self.num_cameras * self.vision.num_patches + self.tokenizer_max_length

    @property
    def suffix_len(self) -> int:
        return 1 + self.chunk_size  # state token + action chunk

    @staticmethod
    def bridge() -> "Pi0Config":
        """pi0_finetune_bridge operating point."""
        return Pi0Config()

    @staticmethod
    def tiny() -> "Pi0Config":
        """CPU-testable config (tiny widths, 2 layers, 28px images)."""
        return Pi0Config(
            vision=siglip_tiny(),
            vlm=gemma_tiny(width=32, depth=2),
            expert=gemma_tiny(width=16, depth=2),
            tokenizer_max_length=8,
            max_state_dim=8,
            max_action_dim=8,
            chunk_size=4,
            n_action_steps=4,
            num_steps=3,
        )
