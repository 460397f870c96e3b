"""LIBERO env adapters (intact_tpu/envs/adapters/libero.py, reference
`src/experiments/env_adapters/libero.py`).

Obs translation for LIBERO/robosuite: cv2 Lanczos resize -> [-1,1], proprio
= xyz + axis-angle (LIBERO trains on axis-angle while the env reports wxyz
quats) + gripper openness from two-finger widths; actions pass through
unchanged (LIBERO training data is already in the env action convention).
The resize is cv2's INTER_LANCZOS4, computed by the port's codec (no cv2).
"""

from __future__ import annotations

import json

import numpy as np

from intact_tpu_torch.envs.adapters.base import BaseEnvAdapter, lanczos_resize
from intact_tpu_torch.native import normalize_u8
from intact_tpu_torch.utils.geometry import quat2axisangle, quat2euler

GRIPPER_CLOSED_WIDTH = 0.015  # per-finger width below which we call it closed


class LiberoAdapter(BaseEnvAdapter):
    def __init__(self, config):
        super().__init__()
        env_cfg = config.env
        self.image_size = tuple(env_cfg.image_size)
        self.state_normalization_type = env_cfg.state_normalization_type
        assert self.state_normalization_type in ("bound", "gaussian")
        with open(env_cfg.dataset_statistics_path) as f:
            self.dataset_statistics = json.load(f)
        self.seed = config.seed

    def reset(self):
        pass

    def preprocess(self, obs: dict) -> dict:
        image = normalize_u8(lanczos_resize(obs["observation.images.top"], self.image_size))[None]

        raw_proprio = self.preprocess_proprio(obs)
        stats = self.dataset_statistics["proprio"]
        if self.state_normalization_type == "bound":
            proprio = self.normalize_bound(
                raw_proprio, np.asarray(stats["p01"]), np.asarray(stats["p99"])
            )
        else:
            proprio = self.normalize_gaussian(
                raw_proprio, np.asarray(stats["mean"]), np.asarray(stats["std"])
            )
        return {
            "image": image,
            "state": proprio[None].astype(np.float32),
            "task": [obs["task"]],
        }

    def postprocess(self, actions: np.ndarray) -> np.ndarray:
        """LIBERO actions need no remapping (training preprocessing already
        matched the env convention, reference libero.py:96-103)."""
        return np.asarray(actions, np.float64)

    def preprocess_proprio(self, obs: dict) -> np.ndarray:
        proprio = np.asarray(obs["observation.state"], np.float64)
        axis_angle = quat2axisangle(proprio[3:7])  # wxyz quat -> axis*angle
        gripper_openness = proprio[7]
        return np.concatenate([proprio[:3], axis_angle, [gripper_openness]])

    @staticmethod
    def gripper_state_from_widths(gripper_width) -> str:
        """Two-finger widths -> 'open'/'closed' (reference heuristic:
        fully open ~ +-0.036..0.039, closed below ~0.015)."""
        if min(abs(gripper_width[0]), abs(gripper_width[1])) < GRIPPER_CLOSED_WIDTH:
            return "closed"
        return "open"


class TacoLiberoAdapter(LiberoAdapter):
    """Variant for models trained on taco_play: proprio keeps the euler
    convention taco uses instead of axis-angle."""

    def preprocess_proprio(self, obs: dict) -> np.ndarray:
        proprio = np.asarray(obs["observation.state"], np.float64)
        euler = quat2euler(proprio[3:7])
        return np.concatenate([proprio[:3], euler, [proprio[7]]])
