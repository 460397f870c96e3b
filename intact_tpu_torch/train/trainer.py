"""Pi0, Pi0FAST and MVLA trainer on one card or on a data x fsdp mesh of ranks: the fused joint step or the standard step.

intact_tpu/train/trainer.py: config -> the process group and the ranks' mesh
(parallel/, one process per card under torchrun; a world of one without it)
-> the model module from the registry -> parameters from the seed
-> training state -> a loop of micro-steps over synthetic batches, prepared
one batch ahead on a worker thread (utils/prefetch.py), logging the
reference's train line (update count, loss, grad norm, lr, time), validating
every `eval_freq` updates (sampled actions against the val split's: l1_loss
and acc@t for each of `eval_thresholds`), saving the state every
`save_model_freq` updates and after the last one under
<log_dir>/<name>/checkpoint/step_{n}/ (train/checkpoint.py), and loading a
checkpoint at start: params only (resume_run false), or the whole state to
resume the run. The train and validation metrics go to W&B through
utils/wandb_gate.py (a no-op run unless use_wandb and wandb is installed);
the run id is saved with each checkpoint and kept on resume.

Two steps, as in the reference:
  * fused_update: train/fused_joint.py, the joint recipe with its update
    inside the backward (no accumulation, no freeze set beyond the embedding);
  * standard: train/train_step.py with make_optimizer (AdamW or 8-bit AdamW,
    fp32 clip, gradient accumulation) over the freeze partition
    (`_freeze_mask`); frozen leaves are stored in bf16 under fp32 masters,
    bf16 masters update with stochastic rounding, and quantize_frozen_int8
    stores the frozen tower in int8 (pi0 expert-only only: the W8A8 product
    has no gradient). The joint path recomputes each layer in the backward
    (per-layer torch.utils.checkpoint), as every joint recipe's `remat: true`
    asks; the expert-only path has no tower backward, and its recipe's
    `remat: false`. Pi0FAST's loss draws nothing; its prefill recomputes each
    layer in the backward, as the reference's does. MVLA's loss runs the
    same prefill under autograd (the metaqueries train through the VLM).

Several ranks (torchrun --nproc_per_node N, NCCL on the cards; gloo with
device "cpu"): `mesh` resolves against the world size (data -1 absorbs what
is left), every rank reads its own episode shard (shard_index rank of
num_shards world) at per_device_batch_size rows, and an update averages
global_batch_size rows: accumulation = global / (per_device x data x fsdp).
  * the standard step is ZeRO-3 over fsdp: the parameters are drawn from
    the seed on the device as on one rank, each leaf moved to the host as
    it is made (`cm.made_on_host`), then placed leaf by leaf on the device
    (`shard_tree(consume=True)`): this rank's `Sharded` slice of every leaf
    that DEFAULT_RULES split, so no rank's device holds the whole tree
    (parallel/sharding.py); its gradient, accumulator and moments are slices
    too (train/optim.py). A layer is whole only inside its forward or its
    recomputed backward, gathered in one collective and its gradient
    reduce-scattered in one (models/common.py's `layer`);
  * the fused step stays ZeRO-2: the parameters whole over fsdp on every
    rank, its optimizer state split over fsdp x tensor in global block rows
    of the one-card pack (train/fused_joint.py).
  * the tensor axis (the standard step of Pi0, Pi0FAST and MVLA, and Pi0's
    fused step; Megatron-style): the ranks of one batch coordinate d * fsdp
    + f read the same episode shard and draw the same noise; each holds its
    tensor slice of the split leaves (column-parallel q, gate, up and fc1,
    row-parallel o, down and fc2, the embedding's vocabulary rows: Pi0FAST's
    tied table trains there, its cross entropy vocabulary-parallel), split
    further over fsdp by ZeRO-3 in the standard step (parallel/tensor.py,
    train/optim.py); the fused step keeps the one-card pack's moments
    (train/fused_joint.py). Octo and the HF-scaffold types refuse
    mesh.tensor > 1.
Rank 0 logs, reports to W&B and writes checkpoints, in the one-rank layout
(gathered leaf by leaf, over fsdp and tensor), so a run resumes on any mesh;
validation samples through the gathered layers, scores each batch
coordinate's rows and averages the metrics over the ranks.

Not ported yet, and refused: the tf.data service
(data.train.service_address). Runs on the CUDA device unless the caller
passes device="cpu".
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from pathlib import Path

import numpy as np
import torch

from intact_tpu_torch import native
from intact_tpu_torch.config.core import to_dict
from intact_tpu_torch.config.pipeline import TrainPipelineConfig, WandBConfig, optimizer_config_from_model_json
from intact_tpu_torch.data.dataset import InterleavedDataset
from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models import registry
from intact_tpu_torch.models.tokenizer import make_tokenizer
from intact_tpu_torch.parallel import MeshConfig, distributed, make_mesh
from intact_tpu_torch.parallel.mesh import refuse_tensor
from intact_tpu_torch.train import checkpoint as ckpt
from intact_tpu_torch.train import fused_joint as fj
from intact_tpu_torch.train import train_step as ts
from intact_tpu_torch.train.optim import cosine_warmup_restarts, make_optimizer
from intact_tpu_torch.utils import wandb_gate
from intact_tpu_torch.utils.metric import get_action_accuracy, l1_error
from intact_tpu_torch.utils.prefetch import PrefetchIterator

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
    images = native.normalize_u8(stacked)  # one fused u8 -> [-1, 1] pass, as the reference's native op
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


# model types whose compute_loss never differentiates through the frozen
# tower (pi0's train_expert_only path runs the prefix under no_grad): the only
# ones where quantize_frozen_int8 is sound
_QUANTIZE_FROZEN_SAFE = {"pi0"}


class Trainer:
    """Pi0 / Pi0FAST / MVLA trainer on one card or a mesh of ranks (fused joint step or standard step)."""

    def __init__(self, cfg: TrainPipelineConfig, device=None):
        self.cfg = cfg
        self._refuse_unported(cfg)
        self.device = distributed.initialize(device)  # idempotent; a world of one without a launcher
        self.mesh = make_mesh(MeshConfig(cfg.mesh.data, cfg.mesh.fsdp, cfg.mesh.tensor))
        self.main_rank = self.mesh.rank == 0
        self.logger = logging.getLogger("intact_tpu_torch.trainer")
        if not self.main_rank:  # rank 0 logs
            self.logger = logging.getLogger(f"intact_tpu_torch.trainer.rank{self.mesh.rank}")
            self.logger.setLevel(logging.WARNING)
        if cfg.model_type.startswith("octo"):
            # the reference's Trainer builds its datasets at model_cfg.vision.image_size
            # (intact_tpu/train/trainer.py:431), which no Octo config has: it cannot train Octo either
            raise NotImplementedError(
                f"the trainer does not train {cfg.model_type!r}: Octo's configs have no `vision` field, which the "
                "reference Trainer builds its datasets from; train Octo through its model's compute_loss, as the "
                "reference does")
        self.model_cfg = cfg.make_model_config()
        self.model = registry.module(cfg.model_type)
        if cfg.master_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"master_dtype must be float32|bfloat16, got {cfg.master_dtype!r}")
        self.bf16_masters = cfg.master_dtype == "bfloat16" and cfg.use_bf16
        n_batch_devices = self.mesh.data * self.mesh.fsdp
        accum = max(1, cfg.global_batch_size // (cfg.per_device_batch_size * n_batch_devices))
        effective_global = accum * cfg.per_device_batch_size * n_batch_devices
        if effective_global != cfg.global_batch_size:
            raise ValueError(
                f"global_batch_size={cfg.global_batch_size} is not a multiple of the micro batch "
                f"{cfg.per_device_batch_size * n_batch_devices} (per_device_batch_size={cfg.per_device_batch_size} "
                f"x {n_batch_devices} data*fsdp devices); training would silently run at effective global batch "
                f"{effective_global}. Adjust global_batch_size or per_device_batch_size.")
        self.micro_batch_size = cfg.per_device_batch_size  # this rank's rows per micro-step
        self.policy = cm.DtypePolicy(param_dtype=torch.float32,
                                     compute_dtype=torch.bfloat16 if cfg.use_bf16 else torch.float32)
        self.opt_cfg = dataclasses.replace(optimizer_config_from_model_json(cfg.model_cfg, cfg),
                                           grad_accumulation_steps=accum)
        self._prequant = None  # (float params template, frozen mask) under quantize_frozen_int8
        if cfg.fused_update:
            self._init_fused(accum)
        else:
            self._init_standard()

        # ---- data ----
        self.tokenizer = make_tokenizer(cfg.resolve_tokenizer_path(), self.model_cfg.tokenizer_max_length,
                                        vocab_size=self.model_cfg.vlm.vocab_size)
        stats = cfg.data.dataset_stats or None
        norm_stats = {"action": stats.get("action"), "proprio": stats.get("observation.state")} if stats else None
        # the scheme the serving adapters invert ("gaussian" there is "normal" here)
        norm_type = "normal" if cfg.env.action_normalization_type == "gaussian" else "bound"
        data_kw = dict(stats=norm_stats, normalization_type=norm_type, image_size=self.model_cfg.vision.image_size)
        # this batch coordinate's episodes (the tensor ranks of a coordinate read the same)
        shards = dict(shard_index=self.mesh.batch_index, num_shards=self.mesh.batch_size)
        self.train_data = InterleavedDataset(cfg.data, self.micro_batch_size, split="train", seed=cfg.seed,
                                             task_paraphrase=cfg.task_paraphrase, **shards, **data_kw)
        self.val_data = InterleavedDataset(cfg.data, self.micro_batch_size, split="val", seed=cfg.seed + 1,
                                           **shards, **data_kw)
        self.cnt_update = 0
        self.data_wait_s = 0.0  # host seconds the loop waited on the next prepared batch
        self._last_saved_update = -1
        self.ckpt_root = Path(cfg.log_dir) / (cfg.name or "run") / "checkpoint"
        if cfg.wandb is None:  # --wandb null: the same as use_wandb false
            cfg.wandb = WandBConfig()
        if cfg.load_from_checkpoint:
            self._load(cfg.load_from_checkpoint, cfg.resume_run)
        self.wandb = wandb_gate.init(cfg.use_wandb and self.main_rank, cfg.wandb.project, name=cfg.name,
                                     entity=cfg.wandb.entity, run_id=cfg.wandb.run_id, config=to_dict(cfg))
        cfg.wandb.run_id = self.wandb.id  # saved with every checkpoint

    def _init_fused(self, accum: int) -> None:
        """The fused joint step and its refusals (as the JAX trainer's)."""
        cfg = self.cfg
        if cfg.model_type != "pi0" or self.model_cfg.train_expert_only:
            raise ValueError("fused_update is the pi0 joint-recipe step (full-tower gradients); use the "
                             "standard path for expert-only or other families")
        if cfg.quantize_frozen_int8:
            raise ValueError("fused_update trains the tower; quantize_frozen_int8 is unsound with it (the "
                             "standard step takes it with train_expert_only)")
        if cfg.freeze_vlm or self.model_cfg.freeze_vision_encoder:
            raise ValueError("fused_update implements the joint recipe's freeze set (embedding only); "
                             "freeze_vlm/freeze_vision_encoder need the standard path")
        if accum > 1:
            raise ValueError(
                "fused_update applies each layer's update inside the backward — gradient accumulation "
                "would need the full gradient tree the mode exists to avoid. Reach the global batch with "
                f"data-parallel chips (global_batch_size={cfg.global_batch_size} needs accumulation {accum} at "
                "this mesh/micro-batch).")
        # parameters: all bf16 (the joint recipe's precision, stochastic
        # rounding), or fp32 trainable leaves with the frozen embedding in bf16
        params = self.model.init(self.model_cfg, cfg.seed, self.device,
                                 torch.bfloat16 if self.bf16_masters else torch.float32)
        if not self.bf16_masters and cfg.use_bf16:
            params["vlm_embed"] = cm.tree_map(lambda x: x.to(torch.bfloat16), params["vlm_embed"])
        params = self._shard(params, over_fsdp=False)  # ZeRO-2: whole over fsdp, tensor slices at tensor > 1
        self.state = fj.init_fused_state(params, cfg.seed, mesh=self.mesh)
        oc = self.opt_cfg
        self.lr_schedule = cosine_warmup_restarts(
            max_lr=oc.lr, first_cycle_steps=oc.first_cycle_steps, warmup_steps=oc.warmup_steps,
            min_lr=oc.min_lr, cycle_mult=oc.cycle_mult, gamma=oc.gamma)
        self.train_step = fj.make_fused_joint_step(
            self.model_cfg, self.opt_cfg, self.policy, stochastic_rounding=self.bf16_masters, mesh=self.mesh)

    def _init_standard(self) -> None:
        """The standard step over the freeze partition."""
        cfg, mc = self.cfg, self.model_cfg
        model = self.model
        frozen_mask = self._freeze_mask(model.init(mc, device="meta"))
        if cfg.quantize_frozen_int8 and (cfg.model_type not in _QUANTIZE_FROZEN_SAFE or not mc.train_expert_only):
            # the W8A8 product has no gradient: a loss that differentiates
            # through the frozen tower would silently lose its signal there
            raise ValueError(
                "quantize_frozen_int8 requires a model whose loss never differentiates through the frozen "
                f"tower (supported: {sorted(_QUANTIZE_FROZEN_SAFE)} with train_expert_only=true); got "
                f"model_type={cfg.model_type!r}, train_expert_only={mc.train_expert_only}")

        def float_params(device):
            # bf16 masters: every leaf bf16 (updates round stochastically);
            # else fp32, with frozen leaves in bf16: they never update
            params = model.init(mc, cfg.seed, device, torch.bfloat16 if self.bf16_masters else torch.float32)
            if not self.bf16_masters and frozen_mask is not None and cfg.use_bf16:
                flat, mask = cm.flatten_paths(params), cm.flatten_paths(frozen_mask)
                params = cm.unflatten_paths({k: v if mask[k] else v.to(torch.bfloat16) for k, v in flat.items()})
            return params

        with cm.made_on_host() if self.mesh.fsdp > 1 or self.mesh.tensor > 1 else contextlib.nullcontext():
            params = float_params(self.device)  # at fsdp > 1 on the host, drawn on the device
        if cfg.quantize_frozen_int8:
            # the tree changes (kernel -> kernel_q/kernel_scale under frozen
            # nodes), so the mask and optimizer are built on the quantized tree
            self._prequant = (float_params("meta"), frozen_mask)
            params = cm.quantize_frozen(params, frozen_mask)
            frozen_mask = self._freeze_mask(params)
        self.frozen_mask = frozen_mask
        params = self._shard(params)
        self.tx, self.lr_schedule = make_optimizer(self.opt_cfg, frozen_mask, mesh=self.mesh)
        self.state = ts.init_train_state(params, self.tx, seed=cfg.seed)

        policy = self.policy  # not self: a step holding the trainer would keep it alive after `del`

        def loss_fn(p, rng, batch, noise, time_):
            return model.compute_loss(p, rng, batch, mc, policy, noise=noise, time=time_)

        self.train_step = ts.make_train_step(loss_fn, self.tx, stochastic_rounding=self.bf16_masters)

    def _shard(self, params, over_fsdp: bool = True):
        """ZeRO-3 at fsdp > 1 (without `over_fsdp`, the fused step's ZeRO-2:
        tensor slices alone): a host tree -> this rank's on the device, leaf
        by leaf: its slice of every leaf the rules split, the rest whole,
        each host leaf released as it is placed. At fsdp 1 and tensor 1 the
        tree as it is."""
        if (self.mesh.fsdp == 1 or not over_fsdp) and self.mesh.tensor == 1:
            return params
        from intact_tpu_torch.parallel.sharding import shard_tree

        heads = self.model.tensor_heads(self.model_cfg) if self.mesh.tensor > 1 else None
        return shard_tree(params, self.mesh, put=lambda x: x.to(self.device), consume=True, heads=heads,
                          over_fsdp=over_fsdp)

    def _freeze_mask(self, params):
        """True = trainable; None when nothing is frozen. The reference's
        freeze flags (intact_tpu/train/trainer.py::_freeze_mask):
        freeze_lm_head freezes pi0's token embedding; freeze_vision_encoder
        SigLIP; freeze_vlm the VLM and embedding; train_expert_only all of
        them and the projector."""
        cfg, mc = self.cfg, self.model_cfg
        freeze_embed = cfg.freeze_lm_head and cfg.model_type == "pi0" and "vlm_embed" in params
        if not (mc.freeze_vision_encoder or cfg.freeze_vlm or mc.train_expert_only or freeze_embed):
            return None
        mask = cm.tree_map(lambda _: True, params)

        def freeze(name):
            mask[name] = cm.tree_map(lambda _: False, mask[name])

        if freeze_embed:
            freeze("vlm_embed")
        if mc.freeze_vision_encoder or mc.train_expert_only:
            freeze("siglip")
        if cfg.freeze_vlm or mc.train_expert_only:
            freeze("vlm")
            freeze("vlm_embed")
            if mc.freeze_vision_encoder or mc.train_expert_only:
                freeze("img_proj")
        # MVLA: the metaqueries stay trainable (their gradient flows back
        # through the frozen VLM) unless freeze_metaqueries, which also cuts
        # the model's backward at the VLM boundary
        if getattr(mc, "freeze_metaqueries", False) and "metaquery" in mask:
            freeze("metaquery")
        return mask

    @staticmethod
    def _refuse_unported(cfg: TrainPipelineConfig) -> None:
        refuse_tensor(MeshConfig(cfg.mesh.data, cfg.mesh.fsdp, cfg.mesh.tensor), registry.family(cfg.model_type))
        if getattr(cfg.data.train, "service_address", None):
            raise NotImplementedError(
                "not ported yet: the tf.data service the RLDS backend would read through "
                "(data.train.service_address); each rank reads its own episode shard instead")

    def device_batch(self, raw: dict) -> dict:
        batch = preprocess_batch(raw, self.tokenizer, self.model_cfg)
        return {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def train(self) -> None:
        cfg = self.cfg
        accum = self.opt_cfg.grad_accumulation_steps
        start, start_update = time.time(), self.cnt_update
        last = start
        window: list[dict] = []
        self.logger.info("training: %d updates x %d accumulation (micro-batch %d on each of %d batch coordinates of "
                         "%d ranks, global %d) on %s, mesh %s", cfg.n_updates, accum, self.micro_batch_size,
                         self.mesh.batch_size, self.mesh.size, cfg.global_batch_size, self.device, self.mesh.shape)
        # the host side (data, preprocess, host-to-device copy) runs a batch ahead
        data = PrefetchIterator(iter(self.train_data), prepare=self.device_batch, depth=2)
        try:
            micro = 0
            while self.cnt_update < cfg.n_updates:
                t = time.perf_counter()
                batch = next(data)
                self.data_wait_s += time.perf_counter() - t
                self.state, metrics = self.train_step(self.state, batch)
                window.append(metrics)
                micro += 1
                if micro % accum:
                    continue
                self.cnt_update += 1  # an emitted update
                if self.cnt_update % cfg.log_freq == 0:
                    now = time.time()
                    self._log_training(window, now - last)
                    window, last = [], now
                if self.cnt_update % cfg.eval_freq == 0:
                    self.validate()
                if self.cnt_update % cfg.save_model_freq == 0:
                    self.save()
        finally:
            data.close()
        if self.cnt_update > start_update and self._last_saved_update != self.cnt_update:
            self.save()  # the last update, when the loop did not just save it
        self.logger.info("training done at update %d in %.2f s", self.cnt_update, time.time() - start)

    def validate(self) -> dict:
        """Sampled actions (sample_actions, noise from generators seeded 1000 +
        i) against eval_size // micro_batch val batches: mean l1_loss and
        acc@t for each of cfg.eval_thresholds."""
        cfg, mc = self.cfg, self.model_cfg
        n_batches = max(1, cfg.eval_size // (self.micro_batch_size * self.mesh.batch_size))
        accs, l1s = [], []
        val_iter = iter(self.val_data)
        for i in range(n_batches):
            batch = self.device_batch(next(val_iter))
            if i == n_batches - 1:
                val_iter.close()  # ends the pass (the RLDS pipeline stops its threads)
            gt = batch.pop("actions")
            batch.pop("action_is_pad", None)
            generator = torch.Generator(device=self.device).manual_seed(1000 + i)
            pred = self.model.sample_actions(self.state.params, generator, batch["images"], batch["img_masks"],
                                      batch["lang_tokens"], batch["lang_masks"], batch["state"], mc, self.policy)
            accs.append(get_action_accuracy(gt, pred, cfg.eval_thresholds))
            l1s.append(l1_error(gt, pred))
        acc = torch.stack(accs).mean(dim=0).tolist()
        metrics = {"l1_loss": torch.stack(l1s).mean().item(), **{f"acc@{t}": a for t, a in zip(cfg.eval_thresholds, acc)}}
        # this rank scored its own rows; the mean over the ranks (the reference all-reduces)
        metrics = distributed.process_mean(metrics)
        self.logger.info("val @ update %d | %s", self.cnt_update,
                         " | ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
        self.wandb.log(metrics, step=self.cnt_update)
        return metrics

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save(self) -> Path:
        """The training state at the current update count (the step_{n}
        contract), in the one-rank layout: every rank gathers, rank 0 writes
        (train/checkpoint.py::save_from_ranks)."""
        path = ckpt.save_from_ranks(self.ckpt_root, self.state.params, self.cnt_update,
                                    aux={"wandb_id": self.cfg.wandb.run_id, "name": self.cfg.name},
                                    train_state=self._global_fields())
        self._last_saved_update = self.cnt_update
        self.logger.info("saved checkpoint %s", path)
        return path

    def _global_fields(self) -> dict:
        """The state's fields but its params, with the optimizer state's
        split moments (and the standard step's accumulators) gathered into
        the one-rank layout (the standard step's kept on process 0 only,
        which writes them; None elsewhere)."""
        fields = ckpt.state_fields(self.state)
        if self.cfg.fused_update:
            fields["mu"], fields["nu"] = fj.global_moments(self.state, self.mesh)
        else:
            fields["opt_state"] = self.tx.global_state(fields["opt_state"], self.state.params)
        return fields

    def _local_fields(self, saved: dict) -> dict:
        """Saved (one-rank layout) fields cut to this rank's slices or rows."""
        out = dict(saved)
        if self.cfg.fused_update:
            out["mu"], out["nu"] = fj.local_moments(self.state, (saved["mu"], saved["nu"]), self.mesh)
        else:
            out["opt_state"] = self.tx.local_state(saved["opt_state"], self.state.params)
        return out

    def _load(self, path: str, resume_run: bool) -> None:
        if self._prequant is not None and not resume_run:
            # quantize_frozen_int8 with a fresh fine-tune: the checkpoint holds
            # float params; restore them into the float template, then
            # quantize the frozen tower (a resume checkpoint is quantized)
            fp_template, mask = self._prequant
            self.state, aux = ckpt.restore_train_state(
                path, self.state, resume_run=False, params_template=fp_template,
                params_transform=lambda p: self._shard(cm.quantize_frozen(p, mask)))
        else:
            self.state, aux = ckpt.restore_train_state(path, self.state, resume_run=resume_run,
                                                       localize=self._local_fields)
        self.cnt_update = int(aux.get("cnt_update", 0)) if resume_run else 0
        if resume_run and self.cfg.wandb.run_id is None:  # the resumed run logs on to its W&B run
            self.cfg.wandb.run_id = aux.get("wandb_id")
        self.logger.info("restored %s (resume=%s, update=%d)", path, resume_run, self.cnt_update)

    def _log_training(self, window: list[dict], seconds: float) -> None:
        # the configured metrics the family's loss reports, Pi0FAST's token accuracy, the grad norm;
        # averaged over the ranks
        mean = {k: float(np.mean([float(m[k]) for m in window]))
                for k in self.cfg.train_log_metrics + ["token_accuracy", "grad_norm"] if k in window[-1]}
        mean = distributed.process_mean(mean)
        # the schedule is indexed by emitted updates
        lr = self.lr_schedule(self.cnt_update)
        line = " | ".join(f"{k} {v:8.5f}" for k, v in mean.items())
        self.logger.info("update %6d | %s | lr %10.8f | t %5.2fs", self.cnt_update, line, lr, seconds)
        self.wandb.log({**mean, "learning rate": lr}, step=self.cnt_update)
