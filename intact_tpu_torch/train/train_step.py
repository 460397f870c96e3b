"""The standard (unfused) training step: loss, gradients of the trainable
leaves, the optimizer's update (intact_tpu/train/train_step.py).

`make_train_step(loss_fn, tx)` returns step(state, batch) -> (state,
metrics). Only the optimizer's trainable leaves (make_optimizer's freeze
partition) get a gradient: each step differentiates detached views of them
that share their storage, so no dL/dW is formed for a frozen leaf, and frozen
int8 leaves (a `quantize_frozen` tower) are plain constants of the loss.
Activation gradients still flow through frozen layers. The optimizer writes
each leaf's update into its storage as soon as it exists; bf16 leaves round
stochastically when asked (the bf16-master recipe).

Random draws: micro-step n takes its flow noise and time, then the seed of
its stochastic-rounding generator, from numpy.random.default_rng((seed, n)),
so a run is reproducible and a resumed run continues bit for bit; the state
holds no generator. The state is updated in place.

Over several ranks (the optimizer's mesh, parallel/): each rank draws its own
rows' noise and time from default_rng((seed, n, rank)); the rounding seed
comes from default_rng((seed, n)), the same on every rank, so data replicas
round their shared leaves with identical bits and stay equal. A row-split
leaf's rows round with a generator seeded from that seed and the fsdp index,
so fsdp ranks never repeat each other's bits. The optimizer reduces the
gradients once per emitted update (train/optim.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from intact_tpu_torch.models.common import flatten_paths, unflatten_paths
from intact_tpu_torch.parallel.sharding import data_draw_key
from intact_tpu_torch.train.optim import Optimizer, global_norm
from intact_tpu_torch.train.optim8bit import add_rounded


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int  # micro-steps taken
    seed: int  # micro-step n draws from numpy.random.default_rng((seed, n))


def init_train_state(params, tx: Optimizer, seed: int = 0) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(params), step=0, seed=seed)


def make_train_step(loss_fn: Callable, tx: Optimizer, stochastic_rounding: bool = False):
    """-> step(state, batch, noise=None, time=None) -> (state, metrics).

    loss_fn(params, rng, batch, noise, time) -> (loss, aux dict), where rng is
    the micro-step's numpy Generator (the loss draws the noise and time that
    are not given). metrics hold 0-dim tensors: l2_loss, grad_norm (this
    rank's micro-step gradients), param_norm (float leaves only: int8 codes
    would wrap) and aux's scalars."""
    mesh = tx.mesh

    def step(state: TrainState, batch: dict, noise=None, time=None):
        draws = np.random.default_rng(data_draw_key(state.seed, state.step, mesh))
        flat = flatten_paths(state.params)
        views = {k: flat[k].detach().requires_grad_() for k in tx.paths(flat)}
        with torch.enable_grad():
            loss, aux = loss_fn(unflatten_paths({**flat, **views}), draws, batch, noise, time)
            grads = torch.autograd.grad(loss, list(views.values()), allow_unused=True, materialize_grads=True)
        grads = dict(zip(views, grads))
        del views
        device = loss.device
        generator = row_generator = None
        if stochastic_rounding:
            shared = draws if mesh.size == 1 else np.random.default_rng((state.seed, state.step))
            sr_seed = int(shared.integers(0, 2**63 - 1))
            generator = row_generator = torch.Generator(device=device).manual_seed(sr_seed)
            if mesh.fsdp > 1:
                row_seed = int(np.random.default_rng((sr_seed, mesh.fsdp_index)).integers(0, 2**63 - 1))
                row_generator = torch.Generator(device=device).manual_seed(row_seed)
        grad_norm = global_norm(grads.values())

        def apply(path, sl, u):
            seg = flat[path].view(-1)[sl]
            gen = generator if tx.shard_of(flat[path]) is None else row_generator
            seg.copy_(add_rounded(seg, u, gen, stochastic_rounding))

        with torch.no_grad():
            tx.apply(grads, state.opt_state, state.params, apply)
        del grads
        metrics = {"l2_loss": loss.detach(), "grad_norm": grad_norm,
                   "param_norm": global_norm(p for p in flat.values() if p.is_floating_point())}
        for k, v in aux.items():
            if v.ndim == 0:
                metrics[k] = v.detach()
        state.step += 1
        return state, metrics

    return step
