"""Open-X-Embodiment dataset registry: per-dataset schemas, mixes, and
standardization transforms (intact_tpu/data/oxe in numpy)."""

from intact_tpu_torch.data.oxe.registry import (
    OXE_DATASET_CONFIGS,
    OXE_NAMED_MIXES,
    make_oxe_dataset_kwargs_and_weights,
)

__all__ = [
    "OXE_DATASET_CONFIGS",
    "OXE_NAMED_MIXES",
    "make_oxe_dataset_kwargs_and_weights",
]
