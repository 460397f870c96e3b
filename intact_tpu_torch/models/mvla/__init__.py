"""MVLA: metaquery-based Pi0 research fork (PaliGemma + metaqueries ->
connector -> self/cross action expert), and its joint "mmmvla" variant."""

from intact_tpu_torch.models.mvla import model
from intact_tpu_torch.models.mvla.config import MVLAConfig

__all__ = ["MVLAConfig", "model"]
