"""Pi0: flow-matching VLA (PaliGemma-3B VLM + Gemma action expert)."""

from intact_tpu_torch.models.pi0 import model
from intact_tpu_torch.models.pi0.config import Pi0Config

__all__ = ["Pi0Config", "model"]
