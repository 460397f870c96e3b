"""Magma-8B: ConvNeXt-XXLarge + projector + LLaMA-3-8B decoding action tokens
(the native path of intact_tpu/models/magma)."""

from intact_tpu_torch.models.magma.config import MagmaConfig

__all__ = ["MagmaConfig"]
