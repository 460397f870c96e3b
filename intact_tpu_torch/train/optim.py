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
    The state: "count" (emitted updates), "mu"/"nu" ({path: moment}), and
    with accumulation "acc" ({path: running mean of the micro-step grads},
    in the dtype of the updates, as MultiSteps holds it after its first
    micro-step: fp32 with 8-bit moments, else the param dtype),
    "mini_step" and "gradient_step"."""

    cfg: OptimizerConfig
    schedule: Callable[[int], float]
    trainable: frozenset | None = None

    def paths(self, flat_params: dict) -> list[str]:
        paths = [k for k in flat_params if self.trainable is None or k in self.trainable]
        for k in paths:
            if not flat_params[k].is_floating_point():
                raise ValueError(f"trainable leaf {k} is {flat_params[k].dtype}; only float leaves train")
        return paths

    def init(self, params) -> dict:
        from intact_tpu_torch.train import optim8bit

        flat = flatten_paths(params)
        state: dict = {"count": 0, "mu": {}, "nu": {}}
        for k in self.paths(flat):
            p = flat[k]
            if self.cfg.quantize_moments:
                state["mu"][k] = optim8bit.init_moment(p, signed=True)
                state["nu"][k] = optim8bit.init_moment(p, signed=False)
            else:
                state["mu"][k], state["nu"][k] = torch.zeros_like(p), torch.zeros_like(p)
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

    def _inner(self, g: dict, state: dict, flat_p: dict, paths: list, sink) -> None:
        from intact_tpu_torch.train import optim8bit

        cfg = self.cfg
        b1, b2 = cfg.betas
        # clip_by_global_norm_f32, one leaf at a time
        scale = clip_factor(global_norm(g[k] for k in paths), cfg.max_grad_norm)
        state["count"] += 1
        c1, c2 = _bias_corrections(b1, b2, state["count"])
        lr = self.schedule(state["count"] - 1)  # scale_by_schedule counts from 0
        for k in paths:
            p, gk = flat_p[k], g[k] * scale.to(g[k].dtype)
            if cfg.quantize_moments:
                chunks = optim8bit.adam8bit_leaf(gk, state["mu"][k], state["nu"][k], c1=c1, c2=c2, b1=b1, b2=b2,
                                                 eps=cfg.eps)
            else:
                chunks = [(slice(0, p.numel()), _adam_leaf(gk, state["mu"][k], state["nu"][k], c1, c2, b1, b2,
                                                           cfg.eps).reshape(-1))]
            for sl, u in chunks:
                if cfg.weight_decay:
                    u = u + cfg.weight_decay * p.reshape(-1)[sl]
                sink(k, sl, u * -lr)
            del gk


def _adam_leaf(g, mu, nu, c1: float, c2: float, b1: float, b2: float, eps: float) -> torch.Tensor:
    """optax.scale_by_adam on one leaf, moments in the param dtype, updated in
    place -> the direction mu_hat / (sqrt(nu_hat) + eps), in fp32."""
    mu.copy_((1 - b1) * g.to(mu.dtype) + b1 * mu)
    nu.copy_((1 - b2) * torch.square(g.to(nu.dtype)) + b2 * nu)
    mu_hat = mu / torch.tensor(c1, dtype=mu.dtype)
    nu_hat = nu / torch.tensor(c2, dtype=nu.dtype)
    return (mu_hat / (torch.sqrt(nu_hat) + eps)).to(torch.float32)


def make_optimizer(cfg: OptimizerConfig, frozen_mask=None) -> tuple[Optimizer, Callable[[int], float]]:
    """-> (Optimizer, schedule). frozen_mask: optional bool tree like the
    params (True = trainable); frozen leaves get no update and no buffer,
    the accumulator included."""
    schedule = cosine_warmup_restarts(
        max_lr=cfg.lr, first_cycle_steps=cfg.first_cycle_steps, warmup_steps=cfg.warmup_steps,
        min_lr=cfg.min_lr, cycle_mult=cfg.cycle_mult, gamma=cfg.gamma,
    )
    trainable = None
    if frozen_mask is not None:
        trainable = frozenset(k for k, t in flatten_paths(frozen_mask).items() if t)
    return Optimizer(cfg, schedule, trainable), schedule
