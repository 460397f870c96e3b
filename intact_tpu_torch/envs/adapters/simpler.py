"""SimplerEnv (ManiSkill2 real2sim) adapters, copied from
intact_tpu/envs/adapters/simpler.py: the Bridge (WidowX) and Google-robot
(EDR) adapters, Octo's Bridge adapter, and SpatialVLA's chunk ensembler:
  * preprocess: cv2 Lanczos resize -> [-1,1] float image; robot-specific
    proprio construction; bound/gaussian state normalization against dataset
    statistics (gripper dim included for proprio)
  * postprocess: denormalize all but the gripper dim, euler -> axis-angle
    rotation, robot-specific gripper mapping (Bridge threshold / EDR sticky)

Resize fidelity matters: each adapter reproduces the interpolation its
model family was evaluated with upstream (cv2 INTER_LANCZOS4 here). cv2 is
imported by the functions that resize, and only for a frame whose size
changes, so the module imports without it.
"""

from __future__ import annotations

import json

import numpy as np

from intact_tpu_torch.envs.adapters.base import BaseEnvAdapter, lanczos_resize
from intact_tpu_torch.utils.device import normalize_u8
from intact_tpu_torch.utils.geometry import euler2axangle, mat2euler, quat2euler, quat2mat


class SimplerAdapter(BaseEnvAdapter):
    def __init__(self, config):
        super().__init__()
        env_cfg = config.env
        self.image_size = tuple(env_cfg.image_size)
        self.action_normalization_type = env_cfg.action_normalization_type
        self.state_normalization_type = env_cfg.state_normalization_type
        assert self.action_normalization_type in ("bound", "gaussian")
        assert self.state_normalization_type in ("bound", "gaussian")

        with open(env_cfg.dataset_statistics_path) as f:
            self.dataset_statistics = json.load(f)
        self.seed = config.seed

    def reset(self):
        pass

    # ---- obs -> model inputs ------------------------------------------

    # serving wrappers set this True (PolicySession): the policy normalizes
    # uint8 frames on the device, so emitting uint8 here skips a whole
    # normalize-then-requantize pass per request. Other callers keep the
    # [-1, 1] float contract by default.
    output_uint8: bool = False

    def preprocess(self, obs: dict) -> dict:
        image = lanczos_resize(obs["observation.images.top"], self.image_size)
        if self.output_uint8:
            image = image[None]
        else:
            image = normalize_u8(image)[None]  # [1, H, W, 3] in [-1, 1]

        # "observation.state" carries the raw env obs (nested agent dict)
        raw_proprio = self.preprocess_proprio(obs["observation.state"])
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

    # ---- model actions -> sim actions ---------------------------------

    def postprocess(self, actions: np.ndarray) -> np.ndarray:
        """[T, 7] normalized (xyz delta, rpy delta, gripper) ->
        [T, 7] simpler actions (xyz, axis-angle, gripper +-1)."""
        actions = np.asarray(actions, np.float32)
        stats = self.dataset_statistics["action"]
        if self.action_normalization_type == "bound":
            body = self.denormalize_bound(
                actions[:, :-1], np.asarray(stats["p01"])[:-1], np.asarray(stats["p99"])[:-1]
            )
        else:
            body = self.denormalize_gaussian(
                actions[:, :-1], np.asarray(stats["mean"])[:-1], np.asarray(stats["std"])[:-1]
            )

        out = np.zeros((len(actions), 7), np.float64)
        for i in range(len(actions)):
            roll, pitch, yaw = body[i, 3:6]
            axis, angle = euler2axangle(roll, pitch, yaw)
            out[i, :3] = body[i, :3]
            out[i, 3:6] = axis * angle
            out[i, 6] = self.postprocess_gripper(float(actions[i, -1]))
        return out

    def preprocess_proprio(self, obs: dict) -> np.ndarray:
        raise NotImplementedError

    def postprocess_gripper(self, action: float) -> float:
        raise NotImplementedError


class BridgeSimplerAdapter(SimplerAdapter):
    """WidowX / BridgeV2: proprio euler is expressed relative to a top-down
    default rotation (the Bridge data convention,
    reference simpler.py:154-190)."""

    # bridge EE frame: rotation mapping base frame -> top-down
    DEFAULT_ROT = np.array([[0, 0, 1.0], [0, 1.0, 0], [-1.0, 0, 0]])

    def preprocess_proprio(self, obs: dict) -> np.ndarray:
        proprio = np.asarray(obs["agent"]["eef_pos"], np.float64)
        rm = quat2mat(proprio[3:7])  # wxyz
        rpy = mat2euler(rm @ self.DEFAULT_ROT.T)
        return np.concatenate([proprio[:3], rpy, [proprio[7]]])

    def postprocess_gripper(self, action: float, binarize: bool = False) -> float:
        # trained with [0,1] (0 close, 1 open) -> simpler wants -1 close / +1 open
        g = 2.0 * (action > 0.5) - 1.0
        return float(np.sign(g)) if binarize else float(g)


class EDRSimplerAdapter(SimplerAdapter):
    """Google-robot (EDR / Fractal): xyzw quat + gripper closedness proprio,
    sticky gripper over 15 action repeats (reference simpler.py:358-421)."""

    STICKY_REPEATS = 15

    def __init__(self, config):
        super().__init__(config)
        self.reset()

    def reset(self):
        self.sticky_action_is_on = False
        self.gripper_action_repeat = 0
        self.sticky_gripper_action = 0.0
        super().reset()

    def preprocess_proprio(self, obs: dict) -> np.ndarray:
        eef = np.asarray(obs["agent"]["eef_pos"], np.float64)
        quat_xyzw = np.roll(eef[3:7], -1)
        gripper_closedness = 1.0 - eef[7]
        return np.concatenate([eef[:3], quat_xyzw, [gripper_closedness]])

    def postprocess_gripper(self, action: float) -> float:
        # [0,1] (0 close) -> relative command with sticky closing
        action = action * 2.0 - 1.0
        relative = -action
        if abs(relative) > 0.5 and not self.sticky_action_is_on:
            self.sticky_action_is_on = True
            self.sticky_gripper_action = relative
        if self.sticky_action_is_on:
            self.gripper_action_repeat += 1
            relative = self.sticky_gripper_action
        if self.gripper_action_repeat == self.STICKY_REPEATS:
            self.sticky_action_is_on = False
            self.gripper_action_repeat = 0
            self.sticky_gripper_action = 0.0
        return float(relative)


class EDREulerSimplerAdapter(EDRSimplerAdapter):
    """EDR variant with euler-angle proprio (reference simpler.py:424-490)."""

    def preprocess_proprio(self, obs: dict) -> np.ndarray:
        eef = np.asarray(obs["agent"]["eef_pos"], np.float64)
        euler = quat2euler(eef[3:7])
        gripper_closedness = 1.0 - eef[7]
        return np.concatenate([eef[:3], euler, [gripper_closedness]])


class OctoBridgeSimplerAdapter(BridgeSimplerAdapter):
    """Octo on Bridge: upstream Octo's eval preprocessing (TF lanczos3 resize
    with antialias, rounded before the clip and the uint8 cast, reference
    simpler.py:305-355; cv2 INTER_LANCZOS4 where TF is absent, a slightly
    different kernel) and gaussian action denormalization. Octo takes no
    proprio: the state is zeros. TF and cv2 are imported when called."""

    def __init__(self, config):
        super().__init__(config)
        self.action_normalization_type = "gaussian"

    def preprocess(self, obs: dict) -> dict:
        try:
            import tensorflow as tf

            # round before the cast: a truncating cast would bias every pixel by ~-0.5
            image = tf.cast(tf.clip_by_value(tf.round(tf.image.resize(
                tf.cast(obs["observation.images.top"], tf.float32), self.image_size, method="lanczos3",
                antialias=True)), 0, 255), tf.uint8).numpy()
        except ImportError:
            import cv2

            h, w = self.image_size  # cv2's dsize is (width, height)
            image = cv2.resize(obs["observation.images.top"], (w, h), interpolation=cv2.INTER_LANCZOS4)
        if not self.output_uint8:
            image = image.astype(np.float32) / 255.0 * 2.0 - 1.0
        return {"image": image[None], "state": np.zeros((1, 7), np.float32), "task": [obs["task"]]}


class ActionEnsembler:
    """Exponentially weighted ensemble over overlapping action chunks (the
    SpatialVLA serving rule, reference simpler.py:492-519)."""

    def __init__(self, pred_horizon: int, ensemble_temp: float = -0.8):
        self.pred_horizon = pred_horizon
        self.ensemble_temp = ensemble_temp
        self.history: list[np.ndarray] = []

    def reset(self):
        self.history.clear()

    def ensemble(self, chunk: np.ndarray) -> np.ndarray:
        """chunk [horizon, dim] -> the ensembled current action [dim]."""
        self.history.append(np.asarray(chunk))
        if len(self.history) > self.pred_horizon:
            self.history.pop(0)
        n = len(self.history)
        # the i-th oldest chunk contributes its (n-1-i)-th action
        preds = np.stack([self.history[i][n - 1 - i] for i in range(n)])
        # weights exp(-temp * i) with i = 0 the oldest chunk: the default
        # temp -0.8 weights the newest prediction most
        weights = np.exp(-self.ensemble_temp * np.arange(n))
        weights /= weights.sum()
        return (weights[:, None] * preds).sum(axis=0)
