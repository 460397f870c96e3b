"""SpatialVLA: SigLIP + Ego3D position encoding + Gemma2 decoding spatial
action-grid tokens (the native path of intact_tpu/models/spatialvla)."""

from intact_tpu_torch.models.spatialvla.config import SpatialVLAConfig

__all__ = ["SpatialVLAConfig"]
