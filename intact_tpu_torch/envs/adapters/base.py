"""Base adapter: normalization helpers shared by all simulators (a copy of
intact_tpu/envs/adapters/base.py)."""

from __future__ import annotations

import numpy as np

from intact_tpu_torch.data import normalize as nz


class BaseEnvAdapter:
    def reset(self) -> None:
        pass

    # bound scheme: [-1, 1] against p01/p99
    def normalize_bound(self, data, data_min, data_max, clip_min=-1.0, clip_max=1.0):
        return nz.normalize_bounds(data, np.asarray(data_min), np.asarray(data_max),
                                   clip=(clip_min, clip_max))

    def denormalize_bound(self, data, data_min, data_max, clip_min=-1.0, clip_max=1.0):
        return nz.denormalize_bounds(data, np.asarray(data_min), np.asarray(data_max),
                                     clip=(clip_min, clip_max))

    def normalize_gaussian(self, data, mean, std):
        return nz.normalize_normal(data, np.asarray(mean), np.asarray(std))

    def denormalize_gaussian(self, data, mean, std):
        return nz.denormalize_normal(data, np.asarray(mean), np.asarray(std))
