"""Pi0FAST: the PaliGemma VLM decodes discretized action tokens (no
flow-matching expert)."""

from intact_tpu_torch.models.pi0fast import model
from intact_tpu_torch.models.pi0fast.config import Pi0FASTConfig

__all__ = ["Pi0FASTConfig", "model"]
