"""Base adapter: normalization helpers shared by all simulators (a copy of
intact_tpu/envs/adapters/base.py), and the adapters' Lanczos resize (cv2's, computed by the codec)."""

from __future__ import annotations

import numpy as np

from intact_tpu_torch.data import codec
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


def lanczos_resize(frame: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(frame, dsize, interpolation=cv2.INTER_LANCZOS4) on a uint8
    frame, dsize being cv2's (width, height), computed by the port's codec bit
    for bit (no cv2 needed). A frame already of that size comes back as a copy,
    which is what cv2 returns for it."""
    if tuple(frame.shape[:2]) == (dsize[1], dsize[0]):
        return np.array(frame)
    frame = np.asarray(frame)
    out = codec.resize_lanczos4(frame.reshape(*frame.shape[:2], -1), (dsize[1], dsize[0]))
    return out.reshape(dsize[1], dsize[0], *frame.shape[2:])
