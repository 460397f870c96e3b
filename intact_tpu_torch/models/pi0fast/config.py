"""Pi0FAST configuration: the reference's fields and defaults, redeclared.

The VLM decodes the action chunk autoregressively as tokens: each action
dimension is binned uniformly into the tail of the vocabulary (horizon x
action_dim tokens per chunk), or, when the host pipeline supplies FAST
DCT+BPE targets (fast_tokenizer.py), the decode window widens to the
tokenizer's vocabulary (`action_vocab_size`).
"""

from __future__ import annotations

import dataclasses

from intact_tpu_torch.models.gemma import GemmaConfig, gemma_2b
from intact_tpu_torch.models.gemma import tiny_test_config as gemma_tiny
from intact_tpu_torch.models.siglip import SigLIPConfig, so400m_14_224
from intact_tpu_torch.models.siglip import tiny_test_config as siglip_tiny


@dataclasses.dataclass(frozen=True)
class Pi0FASTConfig:
    vision: SigLIPConfig = dataclasses.field(default_factory=so400m_14_224)
    vlm: GemmaConfig = dataclasses.field(default_factory=gemma_2b)

    num_cameras: int = 1
    tokenizer_max_length: int = 72

    max_state_dim: int = 32
    max_action_dim: int = 7
    chunk_size: int = 4
    n_action_steps: int = 4

    n_action_bins: int = 256
    action_low: float = -3.0  # normalized-action clip range for binning
    action_high: float = 3.0

    # width of the vocabulary tail greedy decoding may emit; None means
    # n_action_bins (uniform binning); FAST targets set the tokenizer's max_token
    action_vocab_size: int | None = None

    # "pallas": the prefix attention runs the hand-written CUDA kernel on the
    # card (its plain version on the CPU); "xla": the plain einsum path
    attention_impl: str = "pallas"
    freeze_vision_encoder: bool = False
    train_expert_only: bool = False

    @property
    def n_action_tokens(self) -> int:
        return self.chunk_size * self.max_action_dim

    @staticmethod
    def bridge() -> "Pi0FASTConfig":
        return Pi0FASTConfig()

    @staticmethod
    def tiny() -> "Pi0FASTConfig":
        return Pi0FASTConfig(
            vision=siglip_tiny(),
            vlm=gemma_tiny(width=32, depth=2),
            tokenizer_max_length=8,
            max_state_dim=8,
            max_action_dim=3,
            chunk_size=2,
            n_action_bins=32,
        )
