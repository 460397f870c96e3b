"""Single-card trainer for the Pi0 joint recipe with the fused step.

The `fused_update` path of intact_tpu/train/trainer.py: config -> random
parameters from the seed -> fused 8-bit-state AdamW state -> a loop of
`fused_joint` steps over synthetic batches, logging the reference's train line
(update count, loss, grad norm, lr, time), and saving the parameters every
`save_model_freq` updates under <log_dir>/<name>/checkpoint/step_{n}/
(train/checkpoint.py). It keeps the JAX trainer's refusals for settings the
fused step cannot honour. Not ported yet, and refused: the standard (unfused)
step, loading a checkpoint and resuming (optimizer state), validation,
meshes and gradient accumulation, W&B, task paraphrasing.

Runs on the CUDA device unless the caller passes device="cpu".
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from intact_tpu_torch.config.pipeline import TrainPipelineConfig, optimizer_config_from_model_json
from intact_tpu_torch.data.dataset import InterleavedDataset
from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models.pi0 import model as pi0
from intact_tpu_torch.models.tokenizer import make_tokenizer
from intact_tpu_torch.train import checkpoint as ckpt
from intact_tpu_torch.train import fused_joint as fj
from intact_tpu_torch.train.optim import cosine_warmup_restarts

CAMERA_KEYS = ("image_primary", "image_secondary", "image_wrist")


def preprocess_batch(batch: dict, tokenizer, model_cfg) -> dict:
    """RLDS-schema batch -> model inputs (numpy): uint8 frames -> [-1, 1]
    float, instruction bytes -> tokens, proprio/action padded to the model's
    max dims (intact_tpu/train/trainer.py::preprocess_batch).

    Each observation image_* key is one camera [B, T(history), H, W, C]; the
    current (last) history frame of each present camera feeds the model, and
    missing cameras are zero images with img_mask False. An all-zero frame is
    a dropped camera.
    """
    obs = batch["observation"]
    present = [k for k in CAMERA_KEYS if k in obs]
    if not present:
        raise KeyError(f"no camera keys in observation (expected one of {CAMERA_KEYS})")
    if len(present) > model_cfg.num_cameras:
        raise ValueError(
            f"batch has {len(present)} cameras {present} but the model expects "
            f"num_cameras={model_cfg.num_cameras}"
        )

    b = obs[present[0]].shape[0]
    cam_frames, cam_masks = [], []
    for key in present:
        imgs = np.asarray(obs[key])
        if imgs.ndim == 5:  # [B, T, H, W, C] -> current frame
            frame = imgs[:, -1]
        elif imgs.ndim == 4:  # already [B, H, W, C]
            frame = imgs
        else:
            raise ValueError(f"{key}: unexpected image rank {imgs.ndim}")
        cam_frames.append(frame)
        cam_masks.append(frame.reshape(b, -1).any(axis=-1))

    h, w, c = cam_frames[0].shape[1:]
    for _ in range(model_cfg.num_cameras - len(cam_frames)):
        cam_frames.append(np.zeros((b, h, w, c), cam_frames[0].dtype))
        cam_masks.append(np.zeros((b,), bool))

    stacked = np.stack(cam_frames, axis=1).astype(np.uint8)  # [B, K, H, W, C]
    images = stacked.astype(np.float32) * np.float32(2.0 / 255.0) + np.float32(-1.0)
    img_masks = np.stack(cam_masks, axis=1)  # [B, K]

    texts = [s.decode() if isinstance(s, bytes) else str(s) for s in batch["task"]["language_instruction"]]
    lang_tokens, lang_masks = tokenizer(texts, model_cfg.tokenizer_max_length)

    state = np.zeros((b, model_cfg.max_state_dim), np.float32)
    if "proprio" in obs:  # absent when load_proprio=false
        proprio = obs["proprio"][:, -1]  # last history frame
        sd = min(proprio.shape[-1], model_cfg.max_state_dim)
        state[:, :sd] = proprio[:, :sd]

    out = {
        "images": images,
        "img_masks": img_masks,
        "lang_tokens": lang_tokens,
        "lang_masks": lang_masks,
        "state": state,
    }
    if "action" in batch:
        act = batch["action"][:, -1]  # [B, horizon, dim] (last history frame)
        actions = np.zeros((b, model_cfg.chunk_size, model_cfg.max_action_dim), np.float32)
        h = min(act.shape[1], model_cfg.chunk_size)
        ad = min(act.shape[-1], model_cfg.max_action_dim)
        actions[:, :h, :ad] = act[:, :h, :ad]
        out["actions"] = actions
        pad = batch.get("action_pad_mask")
        if pad is not None:
            # a chunk frame is padding if no dim is valid
            valid = pad[:, -1][:, :h].any(axis=-1)
            action_is_pad = np.ones((b, model_cfg.chunk_size), bool)
            action_is_pad[:, :h] = ~valid
            out["action_is_pad"] = action_is_pad
    return out


class Trainer:
    """Pi0 joint-recipe trainer on one card (fused_update)."""

    def __init__(self, cfg: TrainPipelineConfig, device=None):
        self.cfg = cfg
        self.device = cm.resolve_device(device)
        self.logger = logging.getLogger("intact_tpu_torch.trainer")
        self.model_cfg = cfg.make_model_config()
        self._refuse_unported(cfg)

        # ---- the fused step's refusals (as the JAX trainer's) ----
        if cfg.model_type != "pi0" or self.model_cfg.train_expert_only:
            raise ValueError("fused_update is the pi0 joint-recipe step (full-tower gradients); use the "
                             "standard path for expert-only or other families")
        if cfg.quantize_frozen_int8:
            raise ValueError("fused_update trains the tower; quantize_frozen_int8 is unsound with it")
        if cfg.freeze_vlm or self.model_cfg.freeze_vision_encoder:
            raise ValueError("fused_update implements the joint recipe's freeze set (embedding only); "
                             "freeze_vlm/freeze_vision_encoder need the standard path")
        accum = max(1, cfg.global_batch_size // cfg.per_device_batch_size)
        if accum * cfg.per_device_batch_size != cfg.global_batch_size:
            raise ValueError(
                f"global_batch_size={cfg.global_batch_size} is not a multiple of the micro batch "
                f"{cfg.per_device_batch_size} (per_device_batch_size on one device); training would "
                f"silently run at effective global batch {accum * cfg.per_device_batch_size}.")
        if accum > 1:
            raise ValueError(
                "fused_update applies each layer's update inside the backward — gradient accumulation "
                "would need the full gradient tree the mode exists to avoid "
                f"(global_batch_size={cfg.global_batch_size} needs accumulation {accum} on one device).")
        if cfg.master_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"master_dtype must be float32|bfloat16, got {cfg.master_dtype!r}")
        self.bf16_masters = cfg.master_dtype == "bfloat16" and cfg.use_bf16
        if self.device.type == "cuda" and not self.bf16_masters:
            raise ValueError("on CUDA the fused step's row-update kernel takes bf16 parameters: "
                             "set master_dtype: bfloat16 (with use_bf16: true)")

        self.policy = cm.DtypePolicy(param_dtype=torch.float32,
                                     compute_dtype=torch.bfloat16 if cfg.use_bf16 else torch.float32)
        self.opt_cfg = optimizer_config_from_model_json(cfg.model_cfg, cfg)
        self.lr_schedule = cosine_warmup_restarts(
            max_lr=self.opt_cfg.lr, first_cycle_steps=self.opt_cfg.first_cycle_steps,
            warmup_steps=self.opt_cfg.warmup_steps, min_lr=self.opt_cfg.min_lr,
            cycle_mult=self.opt_cfg.cycle_mult, gamma=self.opt_cfg.gamma)

        # parameters: all bf16 (the joint recipe's precision, stochastic
        # rounding), or fp32 trainable leaves with the frozen embedding in bf16
        params = pi0.init(self.model_cfg, cfg.seed, self.device,
                          torch.bfloat16 if self.bf16_masters else torch.float32)
        if not self.bf16_masters and cfg.use_bf16:
            params["vlm_embed"] = cm.tree_map(lambda x: x.to(torch.bfloat16), params["vlm_embed"])
        self.state = fj.init_fused_state(params, cfg.seed)
        self.train_step = fj.make_fused_joint_step(
            self.model_cfg, self.opt_cfg, self.policy, stochastic_rounding=self.bf16_masters)

        # ---- data ----
        self.tokenizer = make_tokenizer(cfg.resolve_tokenizer_path(), self.model_cfg.tokenizer_max_length,
                                        vocab_size=self.model_cfg.vlm.vocab_size)
        stats = cfg.data.dataset_stats or None
        norm_stats = {"action": stats.get("action"), "proprio": stats.get("observation.state")} if stats else None
        # the scheme the serving adapters invert ("gaussian" there is "normal" here)
        norm_type = "normal" if cfg.env.action_normalization_type == "gaussian" else "bound"
        self.micro_batch_size = cfg.per_device_batch_size
        self.train_data = InterleavedDataset(
            cfg.data, self.micro_batch_size, split="train", stats=norm_stats, normalization_type=norm_type,
            seed=cfg.seed, image_size=self.model_cfg.vision.image_size)
        self.cnt_update = 0
        self.ckpt_root = Path(cfg.log_dir) / (cfg.name or "run") / "checkpoint"

    @staticmethod
    def _refuse_unported(cfg: TrainPipelineConfig) -> None:
        unported = {
            "the standard (unfused) training step": not cfg.fused_update,
            "checkpoint loading": bool(cfg.load_from_checkpoint),
            "meshes (the trainer runs on one card)": (cfg.mesh.data not in (-1, 1) or cfg.mesh.fsdp != 1
                                                      or cfg.mesh.tensor != 1),
            "W&B logging": cfg.use_wandb,
            "task paraphrasing": cfg.task_paraphrase,
        }
        missing = [name for name, asked in unported.items() if asked]
        if missing:
            raise NotImplementedError(f"not ported yet: {', '.join(missing)}")

    def device_batch(self, raw: dict) -> dict:
        batch = preprocess_batch(raw, self.tokenizer, self.model_cfg)
        return {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def train(self) -> None:
        cfg = self.cfg
        start = last = time.time()
        window: list[dict] = []
        self.logger.info("training: %d updates, batch %d on %s", cfg.n_updates, self.micro_batch_size, self.device)
        data = iter(self.train_data)
        while self.cnt_update < cfg.n_updates:
            self.state, metrics = self.train_step(self.state, self.device_batch(next(data)))
            window.append(metrics)
            self.cnt_update += 1
            if self.cnt_update % cfg.log_freq == 0:
                now = time.time()
                self._log_training(window, now - last)
                window, last = [], now
            if self.cnt_update % cfg.save_model_freq == 0:
                self.save()
        self.logger.info("training done at update %d in %.2f s", self.cnt_update, time.time() - start)

    def save(self) -> Path:
        """Parameters at the current update count (the step_{n} contract)."""
        path = ckpt.save_checkpoint(self.ckpt_root, self.state.params, self.cnt_update, aux={"name": self.cfg.name})
        self.logger.info("saved checkpoint %s", path)
        return path

    def _log_training(self, window: list[dict], seconds: float) -> None:
        mean = {k: float(np.mean([float(m[k]) for m in window]))
                for k in self.cfg.train_log_metrics + ["grad_norm"] if k in window[-1]}
        # the schedule is indexed by emitted updates
        lr = self.lr_schedule(self.cnt_update)
        line = " | ".join(f"{k} {v:8.5f}" for k, v in mean.items())
        self.logger.info("update %6d | %s | lr %10.8f | t %5.2fs", self.cnt_update, line, lr, seconds)
