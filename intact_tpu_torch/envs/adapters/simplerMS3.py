"""Batched adapters for vectorized ManiSkill3 evaluation, copied from
intact_tpu/envs/adapters/simplerMS3.py: the simpler adapters' math over a
leading batch axis, for the `n_parallel_eval` rollout loop. cv2 is imported
by the function that resizes, and only for frames whose size changes, so the
module imports without it."""

from __future__ import annotations

import numpy as np

from intact_tpu_torch.envs.adapters.base import lanczos_resize
from intact_tpu_torch.envs.adapters.simpler import BridgeSimplerAdapter
from intact_tpu_torch.utils.device import normalize_u8
from intact_tpu_torch.utils.geometry import mat2euler, quat2mat


class BatchBridgeSimplerAdapter(BridgeSimplerAdapter):
    def preprocess(self, obs: dict) -> dict:
        """obs images [N, H, W, 3]; observation.state = eef_pos [N, 8]."""
        imgs = np.asarray(obs["observation.images.top"])
        resized = np.stack([lanczos_resize(im, self.image_size) for im in imgs])
        images = resized if self.output_uint8 else normalize_u8(resized)

        eef = np.asarray(obs["observation.state"], np.float64)  # [N, 8]
        raw = np.stack([self._proprio_one(e) for e in eef])
        stats = self.dataset_statistics["proprio"]
        if self.state_normalization_type == "bound":
            proprio = self.normalize_bound(
                raw, np.asarray(stats["p01"]), np.asarray(stats["p99"])
            )
        else:
            proprio = self.normalize_gaussian(
                raw, np.asarray(stats["mean"]), np.asarray(stats["std"])
            )
        task = obs["task"]
        tasks = list(task) if isinstance(task, (list, tuple, np.ndarray)) else [task] * len(imgs)
        return {"image": images, "state": proprio.astype(np.float32), "task": tasks}

    def _proprio_one(self, eef: np.ndarray) -> np.ndarray:
        rm = quat2mat(eef[3:7])
        rpy = mat2euler(rm @ self.DEFAULT_ROT.T)
        return np.concatenate([eef[:3], rpy, [eef[7]]])

    def postprocess_batch(self, actions: np.ndarray) -> np.ndarray:
        """[N, T, 7] normalized chunks -> [N, T, 7] env actions."""
        return np.stack([self.postprocess(a) for a in np.asarray(actions)])
