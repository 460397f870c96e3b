"""Magma configuration: the reference's fields and defaults, redeclared
(intact_tpu/models/magma/config.py).

A CLIP-ConvNeXt-XXLarge vision tower, a 2-layer projector and a LLaMA-3-8B
language model; actions are read off the first 7 generated tokens through
the 256-bin vocabulary-tail scheme (serve/decoding.tokens_to_actions).
"""

from __future__ import annotations

import dataclasses

from intact_tpu_torch.models.convnext import ConvNeXtConfig, convnext_xxlarge
from intact_tpu_torch.models.convnext import tiny_test_config as convnext_tiny
from intact_tpu_torch.models.llama import LlamaConfig, llama3_8b
from intact_tpu_torch.models.llama import tiny_test_config as llama_tiny


@dataclasses.dataclass(frozen=True)
class MagmaConfig:
    vision: ConvNeXtConfig
    lm: LlamaConfig
    image_size: int = 512  # ConvNeXt input; /32 -> 16 x 16 = 256 tokens
    projector_layers: int = 2  # linear -> exact GELU -> linear
    # the placeholder id the vision features are spliced at: inside
    # lm.vocab_size, the id the checkpoint's tokenizer gives its <image>
    # token (LLaMA-3's last reserved special id by default)
    image_token_id: int = 128_255
    use_chat_template: bool = True  # LLaMA-3-instruct framing
    n_action_tokens: int = 7  # xyz + rpy + gripper, one token each
    n_action_bins: int = 256  # uniform bins at the vocabulary's tail
    max_prompt_tokens: int = 64  # text budget after the image block

    # the fields the pipeline reads off every model config
    type: str = "magma_native"
    chunk_size: int = 1
    n_action_steps: int = 1
    n_obs_steps: int = 1
    num_cameras: int = 1
    tokenizer_max_length: int = 64
    max_state_dim: int = 7
    max_action_dim: int = 7

    @property
    def n_image_tokens(self) -> int:
        patch = self.vision.patch_size * 2 ** (len(self.vision.depths) - 1)
        return (self.image_size // patch) ** 2

    @classmethod
    def magma_8b(cls) -> "MagmaConfig":
        return cls(vision=convnext_xxlarge(), lm=llama3_8b())

    @classmethod
    def tiny(cls) -> "MagmaConfig":
        """CPU-testable point: 2 vision stages (/8 downsample), a 512-row vocabulary."""
        lm = dataclasses.replace(llama_tiny(), vocab_size=512)
        return cls(vision=convnext_tiny(), lm=lm, image_size=32, image_token_id=lm.vocab_size - 300,
                   max_prompt_tokens=12, tokenizer_max_length=12, use_chat_template=False)
