"""Base evaluator (intact_tpu/envs/evaluators/base.py): policy client setup,
checkpoint-step sweep, log-dir layout, summary logging.

Parity with `src/experiments/envs/base_evaluator.py:17-169`:
  * blocks retrying until the policy server binds
  * per-checkpoint `switch_model` round trip + log dir
    eval_online/<sim>/<name>/step_N/ta_K/<seed>/<timestamp>
  * `_log_summary` keeps the exact line format — downstream
    `scripts/eval/gather_*` parsers treat it as an API (SURVEY.md §5.5)

The client is the websocket client unless the caller passes one with the
same surface (`infer`, `reset`, `switch_model`); the websocket client, and
with it `websockets` and `msgpack`, is imported only when none is given.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

from intact_tpu_torch.envs.adapters.language_mapper import PersistentLanguageMapper
from intact_tpu_torch.utils import wandb_gate
from intact_tpu_torch.utils.monitor import setup_logger
from intact_tpu_torch.utils.pipeline import set_seed_everywhere


class BaseEvaluator:
    def __init__(self, pipeline_cfg, client=None):
        self.cfg = pipeline_cfg
        self.eval_cfg = pipeline_cfg.eval_cfg
        self.action_step = self.eval_cfg.action_step

        if pipeline_cfg.name is None:
            self.name = time.strftime("%Y%m%d-%H%M%S") + "_eval_ta" + str(self.action_step)
        else:
            self.name = pipeline_cfg.name

        self.port = self.eval_cfg.port
        self.host = self.eval_cfg.host
        self.debug = pipeline_cfg.debug

        self.gradient_steps = self.eval_cfg.pretrained_model_gradient_step_cnt
        self.no_gradient_steps = self.gradient_steps is None
        if self.no_gradient_steps:
            self.gradient_steps = [0]

        self.simulator_name = self.eval_cfg.simulator_name
        self.task_lists = self.eval_cfg.task_list or []

        self.seed = pipeline_cfg.seed
        set_seed_everywhere(self.seed, train=False)

        self.n_eval_episode = self.eval_cfg.n_eval_episode
        self.n_video = self.eval_cfg.n_video
        self.resize_size = pipeline_cfg.env.image_size

        self.language_mapper = (
            PersistentLanguageMapper(seed=self.seed)
            if self.eval_cfg.language_logic_chain
            else None
        )

        if client is None:
            from intact_tpu_torch.protocol.websocket_policy_client import WebsocketPolicyClient

            client = WebsocketPolicyClient(self.host, self.port)
        self.client = client
        self.main_logger = setup_logger(True, name="evaluator")
        self.main_logger.info("Connected to server at %s:%s", self.host, self.port)
        self.log_dir: Path | None = None

        # gated wandb (reference base_evaluator.py:96-106; no-op unless
        # use_wandb and the library is present)
        wb = getattr(pipeline_cfg, "wandb", None)
        self.wandb = wandb_gate.init(
            bool(getattr(pipeline_cfg, "use_wandb", False)),
            wb.project if wb is not None else "INT-ACT",
            name=self.name,
            entity=wb.entity if wb is not None else None,
            run_id=wb.run_id if wb is not None else None,
            config=None,
        )

    # ------------------------------------------------------------------

    def evaluate(self):
        raise NotImplementedError

    def evaluate_task(self, task_name: str):
        raise NotImplementedError

    def _initialize_model_client(self, model_path: str | None, gradient_step: int):
        """Per-checkpoint: hot-swap the server model, open the log dir."""
        if model_path is not None:
            response = self.client.switch_model(model_path)
            if response.get("status") != "model switched":
                raise RuntimeError(
                    f"Failed to switch to model {model_path} step {gradient_step}"
                )

        self.log_dir = (
            Path(os.environ.get("VLA_LOG_DIR", "log"))
            / "eval_online"
            / self.simulator_name
            / self.name
            / f"step_{gradient_step!s}"
            / f"ta_{self.action_step}"
            / str(self.seed)
            / time.strftime("%Y-%m-%d_%H-%M-%S")
        )
        os.makedirs(self.log_dir, exist_ok=True)
        self.main_logger = setup_logger(
            True,
            filename=None if self.debug else str(self.log_dir / "eval.log"),
            name=f"evaluator.step_{gradient_step}",
            force=True,  # one process may sweep many checkpoints/log dirs
        )
        self.main_logger.info("Model path: %s. Step: %s", model_path, gradient_step)

    def _preprocess_task_instruction(self, instruction: str) -> str:
        if self.language_mapper is None:
            return instruction
        return self.language_mapper.map(instruction)

    def _log_summary(self, logger, cnt_episode: int, eval_time: float, metrics: dict):
        logger.info("============ Evaluation Summary ============")
        logger.info(f"Number of episodes: {cnt_episode}")
        logger.info(f"Total Task Eval Time: {eval_time / 60:.3f} minutes")
        for metric_name, metric_value in metrics.items():
            logger.info(f"{metric_name}: {metric_value:.2%}")
        logger.info("============================================")
