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
round their shared leaves with identical bits and stay equal. ZeRO-3 over
fsdp: a leaf the rules split is a `Sharded` slice; the step differentiates a
detached view of the slice, gathered layer by layer in the forward (and in
each recomputed forward), and the layer buckets' reduce-scatter adds its
gradient, summed over fsdp, into a zeroed slice-sized buffer
(`Sharded.grad`), which the step hands to the optimizer. A split leaf's
slice rounds with a generator seeded from that seed and the fsdp index, so
fsdp ranks never repeat each other's bits. The optimizer reduces the
gradients once per emitted update (train/optim.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from intact_tpu_torch.models.common import flatten_paths, unflatten_paths
from intact_tpu_torch.parallel import collectives
from intact_tpu_torch.parallel.sharding import Sharded, data_draw_key, held
from intact_tpu_torch.train.optim import Optimizer
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
    are not given). metrics hold 0-dim tensors: l2_loss, grad_norm (the
    micro-step gradients at one rank's scale: its own of the replicated
    leaves, the fsdp mean of the split ones), param_norm (of the whole
    leaves after the update, as the JAX step's; float leaves only: int8
    codes would wrap) and aux's scalars. With split leaves the two norms'
    split parts are summed over fsdp in one all-reduce after the update."""
    mesh = tx.mesh

    def step(state: TrainState, batch: dict, noise=None, time=None):
        draws = np.random.default_rng(data_draw_key(state.seed, state.step, mesh))
        flat = flatten_paths(state.params)
        views = {k: _trainable_view(flat[k]) for k in tx.paths(flat)}
        with torch.enable_grad():
            loss, aux = loss_fn(unflatten_paths({**flat, **views}), draws, batch, noise, time)
            grads = torch.autograd.grad(loss, [held(v) for v in views.values()], allow_unused=True)
        grads = {k: v.grad if isinstance(v, Sharded) else g if g is not None else torch.zeros_like(v)
                 for (k, v), g in zip(views.items(), grads)}
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
        grad_sums = _grad_squares(grads, flat, device)

        def apply(path, sl, u):
            p = flat[path]
            seg = held(p).view(-1)[sl]
            gen = row_generator if isinstance(p, Sharded) else generator
            seg.copy_(add_rounded(seg, u, gen, stochastic_rounding))

        with torch.no_grad():
            tx.apply(grads, state.opt_state, state.params, apply)
        del grads
        grad_norm, param_norm = _norms(grad_sums, flat, device)
        metrics = {"l2_loss": loss.detach(), "grad_norm": grad_norm, "param_norm": param_norm}
        for k, v in aux.items():
            if v.ndim == 0:
                metrics[k] = v.detach()
        state.step += 1
        return state, metrics

    return step


def _trainable_view(p):
    """A detached view of a trainable leaf that records its gradient: a split
    leaf's slice with a zeroed gradient buffer for the layer buckets'
    reduce-scatters to add into."""
    if isinstance(p, Sharded):
        return p.with_local(p.local.detach().requires_grad_(), grad=torch.zeros_like(p.local))
    return p.detach().requires_grad_()


def _squares(tensors, device) -> torch.Tensor:
    return sum((torch.square(t.to(torch.float32)).sum() for t in tensors),
               torch.zeros((), dtype=torch.float32, device=device))


def _grad_squares(grads: dict, flat: dict, device) -> torch.Tensor:
    """[replicated, split] sums of squares of the micro-step gradients, taken
    before the optimizer reduces them in place: a split leaf's slice (the
    fsdp sum) divided by its parts, the fsdp mean, so a split gradient counts
    at one rank's scale as a replicated one does."""
    split = {k: g for k, g in grads.items() if isinstance(flat[k], Sharded)}
    rep = _squares((g for k, g in grads.items() if k not in split), device)
    return torch.stack([rep, _squares((g / flat[k].parts for k, g in split.items()), device)])


def _norms(grad_sums: torch.Tensor, flat: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(grad_norm, param_norm) in fp32, the params' after the update: the
    replicated leaves' squares as this rank holds them, the split leaves'
    slices summed over their fsdp group, both norms' in one all-reduce."""
    floats = {k: p for k, p in flat.items() if p.is_floating_point()}
    split = [k for k, p in floats.items() if isinstance(p, Sharded)]
    rep = torch.stack([grad_sums[0], _squares((p for p in floats.values() if not isinstance(p, Sharded)), device)])
    if not split:
        return torch.sqrt(rep[0]), torch.sqrt(rep[1])
    parts = torch.stack([grad_sums[1], _squares((floats[k].local for k in split), device)])
    collectives.all_reduce(parts, flat[split[0]].group)
    sums = rep + parts
    return torch.sqrt(sums[0]), torch.sqrt(sums[1])
