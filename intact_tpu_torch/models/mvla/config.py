"""MVLA configuration: the reference's fields and defaults, redeclared
(intact_tpu/models/mvla/config.py). 108 metaquery tokens, 50-step action
chunks on 7-dof arms, a 12-layer bidirectional connector, and an expert that
alternates self- and cross-attention layers ("self_cross") or runs joint
attention over [prompt | suffix] ("joint", the mmmvla type)."""

from __future__ import annotations

import dataclasses

from intact_tpu_torch.models.connector import ConnectorConfig
from intact_tpu_torch.models.connector import tiny_test_config as connector_tiny
from intact_tpu_torch.models.gemma import GemmaConfig, gemma_2b, gemma_300m_expert
from intact_tpu_torch.models.gemma import tiny_test_config as gemma_tiny
from intact_tpu_torch.models.siglip import SigLIPConfig, so400m_14_224
from intact_tpu_torch.models.siglip import tiny_test_config as siglip_tiny


@dataclasses.dataclass(frozen=True)
class MVLAConfig:
    vision: SigLIPConfig = dataclasses.field(default_factory=so400m_14_224)
    vlm: GemmaConfig = dataclasses.field(default_factory=gemma_2b)
    expert: GemmaConfig = dataclasses.field(default_factory=gemma_300m_expert)
    connector: ConnectorConfig = dataclasses.field(default_factory=ConnectorConfig)

    num_metaqueries: int = 108
    num_cameras: int = 1
    tokenizer_max_length: int = 72

    max_state_dim: int = 7
    max_action_dim: int = 7
    chunk_size: int = 50
    n_action_steps: int = 50
    num_steps: int = 10

    # expert layer pattern: "self_cross" alternates starting with self;
    # "joint" runs plain Gemma blocks over [prompt | suffix]
    alternate_pattern: str = "self_cross"

    # action decoder: "flow" = Gemma expert + flow matching; "dit" = DiT
    # diffusion head over the pooled connector prompt
    action_head: str = "flow"
    dit_width: int = 384
    dit_depth: int = 12
    dit_heads: int = 6
    diffusion_steps: int = 100  # DDPM train steps; sampling uses num_steps (DDIM)

    time_min_period: float = 4e-3
    time_max_period: float = 4.0
    time_beta_alpha: float = 1.5
    time_beta_beta: float = 1.0
    time_scale: float = 0.999
    time_offset: float = 0.001

    # "pallas": the prefix and expert self-attention run the hand-written
    # CUDA kernel on the card (its plain version on the CPU); "xla": plain
    attention_impl: str = "pallas"
    freeze_vision_encoder: bool = False
    train_expert_only: bool = False
    # opt-in: also freeze the metaqueries under train_expert_only, which cuts
    # backprop at the VLM boundary (by default the metaqueries train through
    # the frozen VLM)
    freeze_metaqueries: bool = False

    @property
    def proj_width(self) -> int:
        return self.expert.width

    @staticmethod
    def tiny() -> "MVLAConfig":
        return MVLAConfig(
            vision=siglip_tiny(),
            vlm=gemma_tiny(width=32, depth=2),
            expert=gemma_tiny(width=16, depth=2),
            connector=connector_tiny(),
            num_metaqueries=6,
            tokenizer_max_length=8,
            chunk_size=4,
            n_action_steps=4,
            num_steps=2,
        )
