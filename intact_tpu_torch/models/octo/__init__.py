"""Octo: a block-attention transformer policy with a diffusion action head
(intact_tpu/models/octo): the native model (`model.py`) and the released
architecture with its checkpoint import (`upstream.py`)."""

from intact_tpu_torch.models.octo.config import OctoConfig

__all__ = ["OctoConfig"]
