"""Optimizer hyperparameters and the learning-rate schedule.

`cosine_warmup_restarts` reproduces the reference's
CosineAnnealingWarmupRestarts: linear warmup min_lr -> max_lr over
warmup_steps, cosine decay back to min_lr across the cycle, geometric cycle
growth (cycle_mult) and per-cycle max-lr decay (gamma). It computes in fp32,
as the JAX package's schedule does, and returns a Python float.

The optimizer itself (8-bit-state AdamW, applied per layer inside the
backward) lives in `train/fused_joint.py`; the standard unfused optimizer is
not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np


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
    # blockwise int8 moments for the standard step (not ported yet)
    quantize_moments: bool = False
