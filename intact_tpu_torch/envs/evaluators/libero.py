"""LIBERO evaluator (intact_tpu/envs/evaluators/libero.py, reference
`src/experiments/envs/libero/libero_evaluator.py:85-256`): iterate a
benchmark suite's tasks over fixed initial states, settle each episode with
10 dummy steps (objects drop at reset), flip the upside-down agentview
frames 180 degrees and resize-with-pad, drive the policy server with a
receding-horizon deque, and record per-episode replay videos. Per-suite max
step budgets follow the longest training demos.

`suite_factory`/`env_factory` and the client are injectable so the loop runs
against fakes without the LIBERO/robosuite stack.
"""

from __future__ import annotations

import collections
import os
import time
from pathlib import Path

import numpy as np

from intact_tpu_torch.envs.evaluators.base import BaseEvaluator
from intact_tpu_torch.protocol.image_tools import convert_to_uint8, resize_with_pad

LIBERO_ENV_RESOLUTION = 256
LIBERO_DUMMY_ACTION = [0.0] * 6 + [-1.0]
SETTLE_STEPS = 10

MAX_STEPS = {
    "libero_spatial": 220,  # longest training demo has 193 steps
    "libero_object": 280,   # 254
    "libero_goal": 300,     # 270
    "libero_10": 520,       # 505
    "libero_90": 400,       # 373
}


def _default_suite_factory(task_name: str):
    from libero.libero import benchmark

    return benchmark.get_benchmark_dict()[task_name]()


def _default_env_factory(task, resolution: int, seed: int):
    from libero.libero.envs import OffScreenRenderEnv

    env = OffScreenRenderEnv(
        bddl_file_name=task.bddl_file, camera_heights=resolution,
        camera_widths=resolution,
    )
    env.seed(seed)  # seed affects object positions even with fixed init states
    return env, task.language


class LiberoEvaluator(BaseEvaluator):
    def __init__(self, pipeline_cfg, suite_factory=None, env_factory=None, client=None):
        super().__init__(pipeline_cfg, client=client)
        self.suite_factory = suite_factory or _default_suite_factory
        self.env_factory = env_factory or _default_env_factory
        self.results: dict = {}

    def evaluate(self):
        model_root = self.eval_cfg.pretrained_model_path
        for gradient_step in self.gradient_steps:
            model_path = (
                None if self.no_gradient_steps or model_root is None
                else str(Path(model_root) / f"step_{gradient_step}")
            )
            self._initialize_model_client(model_path, gradient_step)
            for task_name in self.task_lists:
                self.evaluate_task(task_name)
        return self.results

    def evaluate_task(self, task_name: str):
        start = time.time()
        logger = self.main_logger
        logger.info("Task suite: %s", task_name)
        video_dir = self.log_dir / task_name / "videos"
        os.makedirs(video_dir, exist_ok=True)

        suite = self.suite_factory(task_name)
        max_steps = MAX_STEPS.get(task_name)
        if max_steps is None:
            raise ValueError(f"Unknown task name: {task_name}")

        total_episodes, total_successes = 0, 0
        for task_id in range(suite.n_tasks):
            task = suite.get_task(task_id)
            initial_states = suite.get_task_init_states(task_id)
            env, instruction = self.env_factory(task, LIBERO_ENV_RESOLUTION, self.seed)
            instruction = self._preprocess_task_instruction(instruction)

            for episode_idx in range(self.n_eval_episode):
                env.reset()
                obs = env.set_init_state(initial_states[episode_idx % len(initial_states)])
                action_plan: collections.deque = collections.deque()
                replay, success, t = [], False, 0

                while t < max_steps + SETTLE_STEPS:
                    try:
                        if t < SETTLE_STEPS:
                            obs, reward, done, info = env.step(LIBERO_DUMMY_ACTION)
                            t += 1
                            continue

                        # libero agentview frames render upside down
                        img = np.ascontiguousarray(obs["agentview_image"][::-1, ::-1])
                        img = convert_to_uint8(
                            resize_with_pad(img, self.resize_size[0], self.resize_size[1])
                        )
                        replay.append(img)

                        if not action_plan:
                            element = {
                                "observation.images.top": img,
                                "observation.state": np.concatenate([
                                    obs["robot0_eef_pos"],
                                    _quat_wxyz(obs["robot0_eef_quat"]),
                                    [_gripper_openness(obs["robot0_gripper_qpos"])],
                                ]),
                                "task": str(instruction),
                            }
                            chunk = np.asarray(self.client.infer(element))
                            action_plan.extend(chunk[: self.action_step])

                        obs, reward, done, info = env.step(
                            np.asarray(action_plan.popleft(), np.float64)
                        )
                        t += 1
                        if done:
                            success = True
                            break
                    except Exception as e:  # abandon broken episode, keep going
                        logger.warning("episode error: %r", e)
                        break

                total_episodes += 1
                total_successes += int(success)
                self.client.reset()
                self._write_video(replay, video_dir, task_id, episode_idx, success)
            env.close() if hasattr(env, "close") else None

        aggregated = {"Success Rate": total_successes / max(total_episodes, 1)}
        self._log_summary(logger, total_episodes, time.time() - start, aggregated)
        self.results[task_name] = aggregated
        return aggregated

    def _write_video(self, frames, video_dir: Path, task_id: int, episode: int, success: bool):
        if not frames or not self.eval_cfg.recording:
            return
        path = video_dir / f"task{task_id}_ep{episode}{'_success' if success else ''}.mp4"
        try:
            import imageio

            with imageio.get_writer(path) as w:
                for f in frames:
                    w.append_data(f)
        except ImportError:
            np.savez_compressed(str(path.with_suffix(".npz")), *frames)


def _quat_wxyz(q_xyzw: np.ndarray) -> np.ndarray:
    """robosuite reports xyzw; adapters expect wxyz."""
    return np.roll(np.asarray(q_xyzw, np.float64), 1)


def _gripper_openness(qpos) -> float:
    """Two-finger joint positions -> openness in [0, 1] (~0.04 fully open)."""
    return float(np.clip(abs(qpos[0] - qpos[1]) / 0.08, 0.0, 1.0))
