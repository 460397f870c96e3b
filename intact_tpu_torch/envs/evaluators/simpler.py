"""Simpler (ManiSkill2 real2sim) evaluator (intact_tpu/envs/evaluators/simpler.py).

Loop parity with `src/experiments/envs/simpler/simpler_evaluator.py:50-255`:
checkpoint sweep -> per-task env -> episode enumeration via
obj_init_options.episode_id -> receding-horizon action deque (re-infer over
the wire when drained) -> video recording with `_success` renaming ->
intention metrics from episode_stats (Src Intention Correct / Move Correct /
Wrong Obj Attempt / Grasp Correct / Success Rate).

`env_factory` is injectable so the full client loop (protocol + deque +
metrics + logging) is testable against a fake env without the SAPIEN
simulator stack; by default it resolves `simpler_env.make`. `client` too (see
BaseEvaluator). Videos are written with imageio, or as `.npz` frames where
imageio is absent.
"""

from __future__ import annotations

import collections
import os
import time
from pathlib import Path

import numpy as np

from intact_tpu_torch.envs.evaluators.base import BaseEvaluator

METRIC_KEYS = {
    "Success Rate": "success",
    "Move Correct": "moved_correct_obj",
    "Wrong Obj Attempt": "moved_wrong_obj",
    "Grasp Correct": "is_src_obj_grasped",
    "Src Intention Correct": "source_intention",
}


def _default_env_factory(task_name: str):
    import simpler_env

    return simpler_env.make(task_name)


def _default_image_getter(env, obs):
    from simpler_env.utils.env.observation_utils import (
        get_image_from_maniskill2_obs_dict,
    )

    return np.ascontiguousarray(get_image_from_maniskill2_obs_dict(env, obs))


class SimplerEvaluator(BaseEvaluator):
    def __init__(self, pipeline_cfg, env_factory=None, image_getter=None, client=None):
        super().__init__(pipeline_cfg, client=client)
        self.env_factory = env_factory or _default_env_factory
        self.image_getter = image_getter or _default_image_getter
        self.language_logic_chain = self.eval_cfg.language_logic_chain
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
        task_logger = self.main_logger
        task_logger.info("Task suite: %s", task_name)
        video_dir = self.log_dir / task_name / "videos"
        os.makedirs(video_dir, exist_ok=True)

        env = self.env_factory(task_name)
        n_episodes = self._episodes_for(task_name)

        metrics = {k: [] for k in METRIC_KEYS}
        cnt_episode = 0
        obs, reset_info = env.reset(
            seed=self.seed, options={"obj_init_options": {"episode_id": cnt_episode}}
        )
        instruction = self._preprocess_task_instruction(env.get_language_instruction())

        recording = self.n_video > 0 and self.eval_cfg.recording
        frames: list[np.ndarray] = []

        action_plan: collections.deque = collections.deque()
        while True:
            img = self.image_getter(env, obs)

            if not action_plan:
                element = {
                    "observation.images.top": img,
                    "observation.state": obs,
                    "task": str(instruction),
                }
                action_chunk = self.client.infer(element)
                action_plan.extend(np.asarray(action_chunk)[: self.action_step])

            action = action_plan.popleft()
            obs, reward, success, truncated, info = env.step(np.array(action))

            if recording:
                frames.append(img)

            if truncated:
                episode_stats = info.get("episode_stats", {})
                self._process_episode_stats(metrics, episode_stats, success)
                self.client.reset()
                if recording:
                    self._write_video(frames, video_dir, cnt_episode, success)
                    frames = []

                cnt_episode += 1
                task_logger.info("Episode %d stats: %s", cnt_episode, episode_stats)
                if cnt_episode >= n_episodes:
                    break

                if self.language_mapper is not None:
                    self.language_mapper.reset()
                action_plan.clear()
                obs, reset_info = env.reset(
                    options={"obj_init_options": {"episode_id": cnt_episode}}
                )
                instruction = self._preprocess_task_instruction(
                    env.get_language_instruction()
                )
                recording = self.n_video > cnt_episode and self.eval_cfg.recording

        # SAPIEN envs hold renderer/GPU contexts: close explicitly so a
        # multi-task, multi-checkpoint sweep doesn't accumulate them
        if hasattr(env, "close"):
            env.close()

        aggregated = {k: float(np.mean(v)) if v else 0.0 for k, v in metrics.items()}
        self._log_summary(task_logger, cnt_episode, time.time() - start, aggregated)
        self.results[task_name] = aggregated
        self.wandb.log(
            {f"eval/{task_name}/{k}": v for k, v in aggregated.items()}
        )
        return aggregated

    # ------------------------------------------------------------------

    def _episodes_for(self, task_name: str) -> int:
        """Per-task episode tables for google-robot suites
        (reference simpler_evaluator.py:225-235)."""
        if "google_robot" in task_name:
            if "coke" in task_name:
                return 25 * 4
            if "move" in task_name:
                return 60 * 4
            if "drawer" in task_name:
                return 3 * 4 * 9
            if "apple" in task_name:
                return 9 * 4 * 3
        return self.n_eval_episode

    def _process_episode_stats(self, metrics: dict, episode_stats: dict, success):
        metrics["Success Rate"].append(bool(success))
        for name, key in METRIC_KEYS.items():
            if name == "Success Rate":
                continue
            metrics[name].append(episode_stats.get(key, 0))

    def _write_video(self, frames, video_dir: Path, episode: int, success: bool):
        suffix = "_success" if success else ""
        path = video_dir / f"video_{episode}{suffix}.mp4"
        try:
            import imageio

            with imageio.get_writer(path) as w:
                for f in frames:
                    w.append_data(f)
        except ImportError:
            np.savez_compressed(str(path.with_suffix(".npz")), *frames)
