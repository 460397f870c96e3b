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

Over a mesh of ranks (parallel/), ZeRO-3 over fsdp: a leaf the rules split
(parallel/sharding.py's DEFAULT_RULES) is this rank's `Sharded` slice, and
its gradient, accumulator and moments are slices of the same layout (8-bit
codes in the slice's shape, one scale per block of the whole leaf on every
rank: optim8bit.adam8bit_slice, whose per-block max is one all-reduce over
fsdp per leaf). Its gradient arrives summed over the fsdp ranks (the layer
buckets' reduce-scatter in the backward); at an emitted update it is
all-reduced over data and divided by the world size, and the update writes
the slice in place, gathering nothing. A leaf the rules leave whole stays
replicated: each rank accumulates its own gradients, reduced once per update
with one all-reduce over the world. The clip's sum of squares counts each
slice once and each replicated leaf once per fsdp group (the fsdp index 0
rank), summed over fsdp. On one rank nothing is split and the arithmetic is
the single card's.

Over tensor (Pi0, Pi0FAST, MVLA; Megatron-style): a leaf split over tensor
is this rank's tensor slice (split further over fsdp where the rules say so);
its gradient is complete for the slice and is averaged over the batch
coordinates (the data group where it is also fsdp-split, else the batch
group: data x fsdp), never summed over tensor: Pi0FAST's tied table, whose
lookups' and head's gradients both fall on the rank's vocabulary rows.
A leaf replicated over tensor is averaged over the world; where its use is
partial (`partial`, from `tensor.partial_paths`: the one-head K/V kernels,
the sliced q/k/v biases, the connector's q/k norm scales), each tensor
rank's gradient is its part, which the standard step sums over tensor at
every micro-step (train/train_step.py), so it reaches the optimizer whole. The clip counts a
leaf on the ranks that hold distinct parts of it (fsdp index 0 where it is
not fsdp-split, tensor index 0 where it is not tensor-split), summed over
the model group (fsdp x tensor). An 8-bit slice's block scales are the whole
leaf's: one MAX all-reduce over the model group.

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
from intact_tpu_torch.parallel import collectives, distributed, sharding
from intact_tpu_torch.parallel import tensor as tensor_parallel
from intact_tpu_torch.parallel.mesh import Mesh, single_rank_mesh
from intact_tpu_torch.parallel.sharding import Sharded


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
    The state: "count" (emitted updates), "mu"/"nu" ({path: moment}: a
    `Sharded` leaf's in its slice's layout), and with accumulation "acc"
    ({path: running mean of this rank's micro-step grads, a split leaf's
    summed over fsdp}, in the dtype of the updates, as MultiSteps holds it
    after its first micro-step: fp32 with 8-bit moments, else the param
    dtype), "mini_step" and "gradient_step". `mesh`: the ranks
    (parallel.make_mesh); one rank without a group by default."""

    cfg: OptimizerConfig
    schedule: Callable[[int], float]
    trainable: frozenset | None = None
    mesh: Mesh = dataclasses.field(default_factory=single_rank_mesh)
    partial: frozenset = frozenset()  # trainable leaves replicated over tensor whose use is partial (init; the step sums them)

    def paths(self, flat_params: dict) -> list[str]:
        paths = [k for k in flat_params if self.trainable is None or k in self.trainable]
        for k in paths:
            if not flat_params[k].is_floating_point():
                raise ValueError(f"trainable leaf {k} is {flat_params[k].dtype}; only float leaves train")
        return paths

    def _zero_moment(self, p, signed: bool):
        from intact_tpu_torch.train import optim8bit

        if not isinstance(p, Sharded):
            return optim8bit.init_moment(p, signed) if self.cfg.quantize_moments else torch.zeros_like(p)
        if self.cfg.quantize_moments and p.whole_numel() >= optim8bit.MIN_QUANT_ELEMS:
            return optim8bit.init_slice_moment(p.local, p.whole_numel(), signed)
        return torch.zeros_like(p.local, dtype=torch.float32 if self.cfg.quantize_moments else p.dtype)

    def init(self, params) -> dict:
        flat = flatten_paths(params)
        self.partial = tensor_parallel.partial_paths(flat) & frozenset(self.paths(flat))
        state: dict = {"count": 0, "mu": {}, "nu": {}}
        for k in self.paths(flat):
            state["mu"][k] = self._zero_moment(flat[k], signed=True)
            state["nu"][k] = self._zero_moment(flat[k], signed=False)
        if self.cfg.grad_accumulation_steps > 1:
            # MultiSteps keeps the running mean in the dtype of the inner
            # updates: fp32 from the 8-bit AdamW, the param dtype from AdamW
            acc = {}
            for k in self.paths(flat):
                local = sharding.held(flat[k])
                acc[k] = torch.zeros_like(local, dtype=torch.float32 if self.cfg.quantize_moments else local.dtype)
            state.update(mini_step=0, gradient_step=0, acc=acc)
        return state

    def apply(self, grads, state: dict, params, sink) -> bool:
        """One micro-step on `grads` (a tree or {path: grad} holding at least
        the trainable leaves; a `Sharded` leaf's is its slice, summed over
        fsdp). Returns whether an update was emitted."""
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

    def counts_here(self, p) -> bool:
        """Whether this rank's part of leaf p enters a sum over the model
        group (fsdp x tensor) once: a part split over an axis on every rank of
        it, a whole one on the axis's index 0."""
        mesh = self.mesh
        fsdp_split = isinstance(p, Sharded) and p.fsdp_split
        tensor_split = isinstance(p, Sharded) and p.tensor is not None
        return (fsdp_split or mesh.fsdp_index == 0) and (tensor_split or mesh.tensor_index == 0)

    def _reduce(self, g: torch.Tensor, p) -> torch.Tensor:
        """Overwrite g (the accumulator or a micro-step's gradient) with the
        mean over the batch coordinates of the ranks' g, one leaf at a time:
        a fsdp-split leaf's slice (already summed over fsdp) summed over data,
        a leaf split over tensor alone over the batch group, each divided by
        the batch coordinates; a replicated leaf's (a partial one's already
        summed over tensor by the step) over the world, divided by the world
        size. Without a process group g is the mean already."""
        mesh = self.mesh
        if mesh.distributed:
            if isinstance(p, Sharded):
                x = g.to(torch.float32, copy=True)
                collectives.all_reduce(x, mesh.groups["data" if p.fsdp_split else "batch"])
                g.copy_(x / mesh.batch_size)
            else:
                g.copy_(sharding.mean_full(g, mesh))
        return g

    def _inner(self, g: dict, state: dict, flat_p: dict, paths: list, sink) -> None:
        from intact_tpu_torch.train import optim8bit

        cfg, mesh = self.cfg, self.mesh
        b1, b2 = cfg.betas
        g = {k: self._reduce(g[k], flat_p[k]) for k in paths}
        # clip_by_global_norm_f32, one leaf at a time: the sum of squares of
        # this rank's slices, and of the replicated leaves once per model group
        counted = [g[k] for k in paths if self.counts_here(flat_p[k])]
        zero = torch.zeros((), dtype=torch.float32, device=g[paths[0]].device)  # a rank may count no leaf
        ss = sum((torch.square(t.to(torch.float32)).sum() for t in counted), zero)
        if mesh.distributed:
            collectives.all_reduce(ss, mesh.groups["model"])
        scale = clip_factor(torch.sqrt(ss), cfg.max_grad_norm)
        state["count"] += 1
        c1, c2 = _bias_corrections(b1, b2, state["count"])
        lr = self.schedule(state["count"] - 1)  # scale_by_schedule counts from 0
        for k in paths:
            p, gk = flat_p[k], g.pop(k)
            gk = gk * scale.to(gk.dtype)
            p_flat = sharding.held(p).reshape(-1)
            mu, nu = state["mu"][k], state["nu"][k]
            hyper = dict(c1=c1, c2=c2, b1=b1, b2=b2, eps=cfg.eps)
            if isinstance(mu, dict) and isinstance(p, Sharded):
                layout = optim8bit.slice_layout(p.shape, p.dim, p.parts, p.index, p.tensor)
                chunks = optim8bit.adam8bit_slice(gk, mu, nu, layout,
                                                  lambda x: collectives.all_reduce_max(x, mesh.groups["model"]),
                                                  **hyper)
            elif cfg.quantize_moments:
                chunks = optim8bit.adam8bit_leaf(gk, mu, nu, **hyper)
            else:
                chunks = [(slice(0, p_flat.numel()), _adam_leaf(gk, mu, nu, c1, c2, b1, b2, cfg.eps).reshape(-1))]
            for sl, u in chunks:
                if cfg.weight_decay:
                    u = u + cfg.weight_decay * p_flat[sl]
                sink(k, sl, u * -lr)
            del gk

    def global_state(self, state: dict, params, keep: bool | None = None) -> dict:
        """The state in the one-rank layout: the split leaves' moments and
        accumulators gathered over fsdp (8-bit codes into block rows), leaf
        by leaf: what a checkpoint holds. Every rank must call it. A rank
        that keeps them (`keep`; by default process 0, which writes the
        checkpoint) moves each to the host as it is gathered; the others
        drop it and hold None there."""
        from intact_tpu_torch.train import optim8bit

        if keep is None:
            keep = distributed.process_index() == 0
        flat = flatten_paths(params)
        out = dict(state)
        for name in ("mu", "nu", "acc"):
            if name not in state:
                continue
            out[name] = {}
            for k, m in state[name].items():
                p = flat[k]
                if not isinstance(p, Sharded):
                    out[name][k] = m
                    continue
                codes = m["q"] if isinstance(m, dict) else m  # 8-bit: codes in the slice's layout
                whole = sharding.gather_leaf(codes, p)
                if not keep:
                    out[name][k] = None
                elif isinstance(m, dict):  # with the whole leaf's scales, which every rank holds
                    q = optim8bit.slice_to_rows(whole.cpu(), signed=name == "mu")
                    out[name][k] = {"q": q, "scale": m["scale"].cpu()}
                else:
                    out[name][k] = whole.cpu()
                del whole
        return out

    def local_state(self, saved: dict, params) -> dict:
        """A one-rank-layout state (a checkpoint's) cut to this rank's slices."""
        from intact_tpu_torch.train import optim8bit

        flat = flatten_paths(params)
        out = dict(saved)
        for name in ("mu", "nu", "acc"):
            if name not in saved:
                continue
            out[name] = {}
            for k, m in saved[name].items():
                p = flat[k]
                if not isinstance(p, Sharded):
                    out[name][k] = m
                elif isinstance(m, dict):
                    q = sharding.take_slice(optim8bit.rows_to_slice(m["q"], p.whole_shape), p)
                    out[name][k] = {"q": q.contiguous(), "scale": m["scale"]}
                else:
                    out[name][k] = sharding.take_slice(m, p).contiguous()
        return out


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
