"""Optimizer hyperparameters, the learning-rate schedule, and the standard
step's optimizer.

`cosine_warmup_restarts` reproduces the reference's
CosineAnnealingWarmupRestarts: linear warmup min_lr -> max_lr over
warmup_steps, cosine decay back to min_lr across the cycle, geometric cycle
growth (cycle_mult) and per-cycle max-lr decay (gamma). It computes in fp32,
as the JAX package's schedule does, and returns a Python float.

`make_optimizer` is intact_tpu/train/optim.py's optax chain as plain
functions on tensors (`Optimizer`): a global-norm clip accumulated in fp32,
AdamW (optax's moment updates, bias correction, eps outside the square root,
decay added before the learning rate) or the blockwise 8-bit AdamW of
`train/optim8bit.py`, optax MultiSteps' gradient accumulation (running mean,
one emitted update every k micro-steps), and the freeze partition: frozen
leaves get no update and no optimizer buffer. The state is a dict of tensors
and ints, updated in place.

Over a mesh of ranks (parallel/), ZeRO-2 over fsdp: every trainable leaf of
at least optim8bit.MIN_QUANT_ELEMS elements is split in global block rows of
optim8bit.BLOCK_SIZE over the fsdp ranks (`parallel.sharding.row_shard`), its
moments hold only this rank's rows, and its update touches only them; smaller
leaves are replicated. Each rank accumulates its own micro-steps' gradients;
at an emitted update each leaf's mean is reduced once over the ranks
(reduce-scatter over fsdp and all-reduce over data for a row-split leaf, one
all-reduce over the world otherwise), the clip's sum of squares is summed
over the fsdp group (data replicas hold the same rows), and after its update
a row-split leaf is all-gathered over fsdp, so every rank holds the whole
parameters. On one rank the split is the whole leaf and the arithmetic is
the single card's.

The fused step's optimizer (8-bit-state AdamW applied per layer inside the
backward) lives in `train/fused_joint.py`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from intact_tpu_torch.models.common import flatten_paths
from intact_tpu_torch.parallel import collectives, sharding
from intact_tpu_torch.parallel.mesh import Mesh, single_rank_mesh


def cosine_warmup_restarts(
    max_lr: float,
    first_cycle_steps: int,
    warmup_steps: int = 0,
    min_lr: float = 1e-8,
    cycle_mult: float = 1.0,
    gamma: float = 1.0,
) -> Callable[[int], float]:
    if warmup_steps >= first_cycle_steps:
        raise ValueError("warmup_steps must be < first_cycle_steps")
    f32 = np.float32

    def schedule(count: int) -> float:
        step = f32(count)
        if cycle_mult == 1.0:
            cycle = np.floor(step / f32(first_cycle_steps))
            step_in_cycle = step - cycle * f32(first_cycle_steps)
            cycle_steps = f32(first_cycle_steps)
        else:
            # cycle n starts at first*(mult^n - 1)/(mult - 1)
            ratio = step / f32(first_cycle_steps) * f32(cycle_mult - 1.0) + f32(1.0)
            cycle = np.floor(np.log(ratio) / f32(math.log(cycle_mult)))
            cycle_start = f32(first_cycle_steps) * (f32(cycle_mult) ** cycle - f32(1.0)) / f32(cycle_mult - 1.0)
            step_in_cycle = step - cycle_start
            cycle_steps = f32(first_cycle_steps) * f32(cycle_mult) ** cycle
        cur_max = f32(max_lr) * f32(gamma) ** cycle
        if step_in_cycle < warmup_steps:
            lr = f32(min_lr) + (cur_max - f32(min_lr)) * step_in_cycle / f32(max(warmup_steps, 1))
        else:
            lr = f32(min_lr) + (cur_max - f32(min_lr)) * f32(0.5) * (
                f32(1.0) + np.cos(f32(np.pi) * (step_in_cycle - f32(warmup_steps)) / (cycle_steps - f32(warmup_steps)))
            )
        return float(f32(lr))

    return schedule


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 5e-5
    weight_decay: float = 1e-5
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_steps: int = 200
    first_cycle_steps: int = 10_000_000  # effectively single-cycle by default
    min_lr: float = 1e-8
    cycle_mult: float = 1.0
    gamma: float = 1.0
    grad_accumulation_steps: int = 1
    # blockwise int8 moments for the standard step (train/optim8bit.py)
    quantize_moments: bool = False


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, summed in fp32."""
    return torch.sqrt(sum(torch.square(t.to(torch.float32)).sum() for t in tensors))


def clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """intact_tpu/train/optim.py::clip_by_global_norm_f32's factor: every
    grad is scaled by min(1, max_norm / max(norm, 1e-16)) in its own dtype."""
    return torch.clamp(max_norm / norm.clamp_min(1e-16), max=1.0)


def _bias_corrections(b1: float, b2: float, count: int) -> tuple[float, float]:
    cf = np.float32(count)
    return (float(np.float32(1.0) - np.float32(b1) ** cf), float(np.float32(1.0) - np.float32(b2) ** cf))


@dataclasses.dataclass
class Optimizer:
    """The standard step's optimizer: `init(params) -> state` and
    `apply(grads, state, params, sink) -> emitted`, which hands each
    trainable leaf's update to `sink(path, flat_slice, update)` as soon as it
    exists, so the whole update tree never lives at once.

    `trainable` holds the paths of the trainable leaves (None: every leaf).
    The state: "count" (emitted updates), "mu"/"nu" ({path: moment}: this
    rank's rows of a row-split leaf), and with accumulation "acc" ({path:
    running mean of this rank's micro-step grads}, in the dtype of the
    updates, as MultiSteps holds it after its first micro-step: fp32 with
    8-bit moments, else the param dtype), "mini_step" and "gradient_step".
    `mesh`: the ranks (parallel.make_mesh); one rank without a group by
    default."""

    cfg: OptimizerConfig
    schedule: Callable[[int], float]
    trainable: frozenset | None = None
    mesh: Mesh = dataclasses.field(default_factory=single_rank_mesh)

    def paths(self, flat_params: dict) -> list[str]:
        paths = [k for k in flat_params if self.trainable is None or k in self.trainable]
        for k in paths:
            if not flat_params[k].is_floating_point():
                raise ValueError(f"trainable leaf {k} is {flat_params[k].dtype}; only float leaves train")
        return paths

    def shard_of(self, p: torch.Tensor) -> sharding.RowShard | None:
        """This rank's block rows of a trainable leaf, or None for a
        replicated one (below optim8bit.MIN_QUANT_ELEMS elements)."""
        from intact_tpu_torch.train import optim8bit

        if p.numel() < optim8bit.MIN_QUANT_ELEMS:
            return None
        return sharding.row_shard(p.numel(), optim8bit.BLOCK_SIZE, self.mesh.fsdp, self.mesh.fsdp_index)

    def _zero_moment(self, p: torch.Tensor, signed: bool):
        from intact_tpu_torch.train import optim8bit

        shard = self.shard_of(p)
        if self.cfg.quantize_moments:
            return optim8bit.init_moment(p, signed, rows=shard.per if shard else None)
        if shard is None or shard.whole:
            return torch.zeros_like(p)
        return torch.zeros(shard.per * shard.block, dtype=p.dtype, device=p.device)

    def init(self, params) -> dict:
        flat = flatten_paths(params)
        state: dict = {"count": 0, "mu": {}, "nu": {}}
        for k in self.paths(flat):
            state["mu"][k] = self._zero_moment(flat[k], signed=True)
            state["nu"][k] = self._zero_moment(flat[k], signed=False)
        if self.cfg.grad_accumulation_steps > 1:
            # MultiSteps keeps the running mean in the dtype of the inner
            # updates: fp32 from the 8-bit AdamW, the param dtype from AdamW
            acc_dtype = (lambda p: torch.float32) if self.cfg.quantize_moments else (lambda p: p.dtype)
            state.update(mini_step=0, gradient_step=0,
                         acc={k: torch.zeros_like(flat[k], dtype=acc_dtype(flat[k])) for k in self.paths(flat)})
        return state

    def apply(self, grads, state: dict, params, sink) -> bool:
        """One micro-step on `grads` (a tree or {path: grad} holding at least
        the trainable leaves). Returns whether an update was emitted."""
        flat_p = flatten_paths(params)
        flat_g = flatten_paths(grads)
        paths = self.paths(flat_p)
        g = {k: flat_g[k] for k in paths}
        k_steps = self.cfg.grad_accumulation_steps
        if k_steps > 1:
            n = state["mini_step"]
            for k in paths:
                acc = state["acc"][k]
                acc.add_((g[k].to(acc.dtype) - acc) / (n + 1))  # MultiSteps' running mean
            state["mini_step"] = (n + 1) % k_steps
            if n != k_steps - 1:
                return False
            g = state["acc"]
        self._inner(g, state, flat_p, paths, sink)
        if k_steps > 1:
            for acc in state["acc"].values():
                acc.zero_()
            state["gradient_step"] += 1
        return True

    def _reduce(self, g: torch.Tensor, shard) -> torch.Tensor:
        """Overwrite g (the accumulator or a micro-step's gradient) with the
        world mean of the ranks' g, at this rank's rows of a row-split leaf,
        one leaf at a time; -> the rows this rank updates (all of g for a
        replicated or whole leaf, flat rows otherwise). Without a process
        group g is the mean already."""
        if self.mesh.distributed:
            if shard is None:
                g.copy_(sharding.mean_full(g, self.mesh))
            else:
                g.view(-1)[shard.e0:shard.e1].copy_(sharding.mean_rows(g, shard, self.mesh))
        return g if shard is None or shard.whole else g.view(-1)[shard.e0:shard.e1]

    def _inner(self, g: dict, state: dict, flat_p: dict, paths: list, sink) -> None:
        from intact_tpu_torch.train import optim8bit

        cfg, mesh = self.cfg, self.mesh
        b1, b2 = cfg.betas
        shards = {k: self.shard_of(flat_p[k]) for k in paths}
        g = {k: self._reduce(g[k], shards[k]) for k in paths}
        # clip_by_global_norm_f32, one leaf at a time: the sum of squares of
        # this rank's rows, and of the replicated leaves once per fsdp group
        counted = [g[k] for k in paths if shards[k] is not None or mesh.fsdp_index == 0]
        zero = torch.zeros((), dtype=torch.float32, device=flat_p[paths[0]].device)  # a rank may count no leaf
        ss = sum((torch.square(t.to(torch.float32)).sum() for t in counted), zero)
        if mesh.distributed:
            collectives.all_reduce(ss, mesh.groups["fsdp"])
        scale = clip_factor(torch.sqrt(ss), cfg.max_grad_norm)
        state["count"] += 1
        c1, c2 = _bias_corrections(b1, b2, state["count"])
        lr = self.schedule(state["count"] - 1)  # scale_by_schedule counts from 0
        for k in paths:
            p, gk, shard = flat_p[k], g.pop(k), shards[k]
            gk = gk * scale.to(gk.dtype)
            e0, e1 = (shard.e0, shard.e1) if shard is not None else (0, p.numel())
            p_rows = p.reshape(-1)[e0:e1]
            mu, nu = state["mu"][k], state["nu"][k]
            if cfg.quantize_moments:
                if shard is not None:  # the leaf's valid rows of the (padded) local moments
                    mu = {"q": mu["q"][:shard.rows], "scale": mu["scale"][:shard.rows]}
                    nu = {"q": nu["q"][:shard.rows], "scale": nu["scale"][:shard.rows]}
                chunks = optim8bit.adam8bit_leaf(gk, mu, nu, c1=c1, c2=c2, b1=b1, b2=b2, eps=cfg.eps)
            else:
                if shard is not None and not shard.whole:
                    mu, nu = mu[:e1 - e0], nu[:e1 - e0]
                chunks = [(slice(0, e1 - e0), _adam_leaf(gk, mu, nu, c1, c2, b1, b2, cfg.eps).reshape(-1))]
            for sl, u in chunks:
                if cfg.weight_decay:
                    u = u + cfg.weight_decay * p_rows[sl]
                sink(k, slice(e0 + sl.start, e0 + sl.stop), u * -lr)
            del gk
            if shard is not None and mesh.distributed:
                sharding.gather_rows(p.view(-1), shard, mesh)

    def global_state(self, state: dict, params) -> dict:
        """The state in the one-rank layout (the fsdp ranks' moment rows
        gathered; the accumulator is this rank's own): what a checkpoint
        holds. Every rank must call it."""
        return self._map_moments(state, params, to_global=True)

    def local_state(self, saved: dict, params) -> dict:
        """A one-rank-layout state (a checkpoint's) cut to this rank's rows."""
        return self._map_moments(saved, params, to_global=False)

    def _map_moments(self, state: dict, params, to_global: bool) -> dict:
        flat = flatten_paths(params)
        out = dict(state)
        for name in ("mu", "nu"):
            out[name] = {}
            for k, m in state[name].items():
                p, shard = flat[k], self.shard_of(flat[k])
                if shard is None:
                    out[name][k] = m
                elif isinstance(m, dict):  # 8-bit codes [rows, block] and scales [rows, 1]
                    out[name][k] = {f: self._move(m[f], shard, shard.per, shard.nb, to_global) for f in m}
                else:  # fp32 moments: p-shaped when whole, else flat rows
                    x = self._move(m.reshape(-1), shard, shard.per * shard.block, shard.n, to_global)
                    out[name][k] = x.view(p.shape) if to_global or shard.whole else x
        return out

    def _move(self, x: torch.Tensor, shard, per: int, total: int, to_global: bool) -> torch.Tensor:
        if to_global:
            return sharding.gather_leading(x, self.mesh, total)
        return x if shard.whole else sharding.take_leading(x, shard, per)


def _adam_leaf(g, mu, nu, c1: float, c2: float, b1: float, b2: float, eps: float) -> torch.Tensor:
    """optax.scale_by_adam on one leaf, moments in the param dtype, updated in
    place -> the direction mu_hat / (sqrt(nu_hat) + eps), in fp32."""
    mu.copy_((1 - b1) * g.to(mu.dtype) + b1 * mu)
    nu.copy_((1 - b2) * torch.square(g.to(nu.dtype)) + b2 * nu)
    mu_hat = mu / torch.tensor(c1, dtype=mu.dtype)
    nu_hat = nu / torch.tensor(c2, dtype=nu.dtype)
    return (mu_hat / (torch.sqrt(nu_hat) + eps)).to(torch.float32)


def make_optimizer(cfg: OptimizerConfig, frozen_mask=None,
                   mesh: Mesh | None = None) -> tuple[Optimizer, Callable[[int], float]]:
    """-> (Optimizer, schedule). frozen_mask: optional bool tree like the
    params (True = trainable); frozen leaves get no update and no buffer,
    the accumulator included. mesh: the ranks (one rank by default)."""
    schedule = cosine_warmup_restarts(
        max_lr=cfg.lr, first_cycle_steps=cfg.first_cycle_steps, warmup_steps=cfg.warmup_steps,
        min_lr=cfg.min_lr, cycle_mult=cfg.cycle_mult, gamma=cfg.gamma,
    )
    trainable = None
    if frozen_mask is not None:
        trainable = frozenset(k for k, t in flatten_paths(frozen_mask).items() if t)
    return Optimizer(cfg, schedule, trainable, mesh or single_rank_mesh()), schedule
