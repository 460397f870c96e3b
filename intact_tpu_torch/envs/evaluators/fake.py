"""Fake simulator env: hermetic stand-in for SimplerEnv (a copy of
intact_tpu/envs/evaluators/fake.py).

Implements the gym-ish surface the evaluator drives (reset/step/
get_language_instruction + episode_stats in info) with scripted dynamics:
an episode "succeeds" when the cumulative commanded xyz displacement crosses
a threshold toward a per-episode goal. Used to test the FULL
client-evaluator loop (protocol round trips, receding-horizon deque, metric
aggregation, video paths) without SAPIEN — the fake-env strategy SURVEY.md
§4 calls for.
"""

from __future__ import annotations

import numpy as np


class FakeSimplerEnv:
    max_episode_steps = 24

    def __init__(self, task_name: str = "widowx_carrot_on_plate", image_size: int = 64):
        self.task_name = task_name
        self.image_size = image_size
        self._episode_id = 0
        self._t = 0
        self._pos = np.zeros(3)
        self._goal = np.zeros(3)
        self._grasped = False

    # -- gym surface ----------------------------------------------------

    def reset(self, seed=None, options=None):
        opts = (options or {}).get("obj_init_options", {})
        self._episode_id = int(opts.get("episode_id", 0))
        rng = np.random.default_rng((seed or 0) + self._episode_id)
        self._t = 0
        self._pos = np.zeros(3)
        self._goal = rng.uniform(-0.05, 0.05, size=3)
        self._grasped = False
        return self._obs(), {"episode_id": self._episode_id}

    def step(self, action):
        action = np.asarray(action, np.float64)
        self._pos = self._pos + action[:3]
        if action[6] > 0:  # close gripper near goal -> grasp
            if np.linalg.norm(self._pos - self._goal) < 0.1:
                self._grasped = True
        self._t += 1
        truncated = self._t >= self.max_episode_steps
        success = bool(self._grasped and np.linalg.norm(self._pos - self._goal) < 0.1)
        info = {}
        if truncated:
            info["episode_stats"] = {
                "moved_correct_obj": int(self._grasped),
                "moved_wrong_obj": 0,
                "is_src_obj_grasped": int(self._grasped),
                "source_intention": int(np.dot(self._pos, self._goal) > 0),
            }
        return self._obs(), 0.0, success, truncated, info

    def get_language_instruction(self) -> str:
        return "put the carrot on the plate"

    # -- helpers --------------------------------------------------------

    def _obs(self):
        s = self.image_size
        img = np.full((s, s, 3), 128, np.uint8)
        # proprio layout the Bridge adapter expects: xyz, wxyz quat, gripper
        eef = np.concatenate([self._pos, [1.0, 0, 0, 0], [1.0 - 0.5 * self._grasped]])
        return {
            "image": img,
            "agent": {"eef_pos": eef},
        }


def fake_env_factory(task_name: str):
    return FakeSimplerEnv(task_name)


def fake_image_getter(env, obs):
    return obs["image"]
