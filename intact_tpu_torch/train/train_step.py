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

Over tensor (Pi0, Pi0FAST, MVLA; parallel/tensor.py): the draws are keyed on the batch
coordinate d * fsdp + f, so the tensor ranks of one coordinate draw the same
noise and time for the same rows; a leaf split over tensor alone is
differentiated as the slice it is (autograd forms its gradient); the
gradient of a leaf replicated over tensor whose use is partial (the
optimizer's `partial`: the one-head K/V kernels, SigLIP's and the DiT's q/k/v
biases, the connector's q/k norm scales) is each
rank's part, summed over tensor at once, before the norms and the
accumulation; a tensor slice rounds with a generator seeded from the
rounding seed, its fsdp index and its tensor index, while the leaves
replicated over tensor round alike on every tensor rank.
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
    micro-step gradients at one rank's scale: its own rows' of every leaf
    not split over fsdp, over all its tensor slices, the fsdp mean of the
    fsdp-split ones; at one batch coordinate, one card's), param_norm (of the whole
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
        grads = {k: v.grad if isinstance(v, Sharded) and v.fsdp_split else g if g is not None else
                 torch.zeros_like(held(v)) for (k, v), g in zip(views.items(), grads)}
        del views
        device = loss.device
        generators: dict = {}
        sr_seed = None
        if stochastic_rounding:
            shared = draws if mesh.batch_size == 1 else np.random.default_rng((state.seed, state.step))
            sr_seed = int(shared.integers(0, 2**63 - 1))

        def generator_of(p):
            """The leaf's rounding generator: one per (fsdp part, tensor slice)
            it is split into, the shared one for a leaf held whole."""
            key = (p.index if p.fsdp_split and mesh.fsdp > 1 else None, p.tensor.index if p.tensor else None) \
                if isinstance(p, Sharded) else (None, None)
            if key not in generators:
                seed = sr_seed
                if key != (None, None):  # (fsdp part), (fsdp part, tensor slice) or (2^32 - 1, tensor slice)
                    salt = (key[0],) if key[1] is None else (2**32 - 1 if key[0] is None else key[0], key[1])
                    seed = int(np.random.default_rng((sr_seed, *salt)).integers(0, 2**63 - 1))
                generators[key] = torch.Generator(device=device).manual_seed(seed)
            return generators[key]

        if tx.partial:
            _sum_partials(grads, tx)
        grad_sums = _grad_squares(grads, flat, tx, device)

        def apply(path, sl, u):
            p = flat[path]
            seg = held(p).view(-1)[sl]
            gen = generator_of(p) if stochastic_rounding else None
            seg.copy_(add_rounded(seg, u, gen, stochastic_rounding))

        with torch.no_grad():
            tx.apply(grads, state.opt_state, state.params, apply)
        del grads
        grad_norm, param_norm = _norms(grad_sums, flat, tx, device)
        metrics = {"l2_loss": loss.detach(), "grad_norm": grad_norm, "param_norm": param_norm}
        for k, v in aux.items():
            if v.ndim == 0:
                metrics[k] = v.detach()
        state.step += 1
        return state, metrics

    return step


def _trainable_view(p):
    """A detached view of a trainable leaf that records its gradient: a
    fsdp-split leaf's slice with a zeroed gradient buffer for the layer
    buckets' reduce-scatters to add into (a leaf split over tensor alone:
    its slice, whose gradient autograd forms)."""
    if isinstance(p, Sharded):
        return p.with_local(p.local.detach().requires_grad_(), grad=torch.zeros_like(p.local) if p.fsdp_split else None)
    return p.detach().requires_grad_()


def _squares(tensors, device) -> torch.Tensor:
    return sum((torch.square(t.to(torch.float32)).sum() for t in tensors),
               torch.zeros((), dtype=torch.float32, device=device))


def _sum_partials(grads: dict, tx: Optimizer) -> None:
    """The gradients of the leaves replicated over tensor whose use is
    partial (`tx.partial`: each tensor rank's holds its heads' part) summed
    over tensor in place, in fp32, in one all-reduce: after it every tensor
    rank holds the leaf's whole gradient of its rows, as for any replicated
    leaf."""
    paths = sorted(tx.partial)  # one order on every rank
    flat = torch.cat([grads[k].reshape(-1).to(torch.float32) for k in paths])
    collectives.tensor_all_reduce(flat, tx.mesh.groups["tensor"])
    for k, x in zip(paths, flat.split([grads[k].numel() for k in paths])):
        grads[k].copy_(x.view_as(grads[k]))


def _grad_squares(grads: dict, flat: dict, tx: Optimizer, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The sums of squares of the micro-step gradients at one rank's scale,
    taken before the optimizer reduces them in place -> (this rank's whole
    leaves', [the fsdp-split slices', the tensor-only slices' in the slot of
    this rank's fsdp index of `mesh.fsdp` slots]). A fsdp-split slice (the
    fsdp sum) counts divided by its parts, the fsdp mean, on the ranks
    `tx.counts_here`; a slice split over tensor alone counts its own rows on
    every rank, summed over tensor through its slot."""
    whole = _squares((g for k, g in grads.items() if not isinstance(flat[k], Sharded)), device)
    fsdp = [k for k in grads if isinstance(flat[k], Sharded) and flat[k].fsdp_split and tx.counts_here(flat[k])]
    slots = torch.zeros(tx.mesh.fsdp, dtype=torch.float32, device=device)
    slots[tx.mesh.fsdp_index] = _squares((g for k, g in grads.items()
                                          if isinstance(flat[k], Sharded) and not flat[k].fsdp_split), device)
    return whole, torch.cat([_squares((grads[k] / flat[k].parts for k in fsdp), device)[None], slots])


def _norms(grad_sums: tuple, flat: dict, tx: Optimizer, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(grad_norm, param_norm) in fp32, the params' after the update: the
    whole leaves' squares as this rank holds them, the split leaves' parts
    summed over the model group (fsdp x tensor), each part once, both
    norms' in one all-reduce."""
    floats = {k: p for k, p in flat.items() if p.is_floating_point()}
    split = [k for k, p in floats.items() if isinstance(p, Sharded)]
    grad_whole, grad_parts = grad_sums
    param_whole = _squares((p for p in floats.values() if not isinstance(p, Sharded)), device)
    if not split:
        return torch.sqrt(grad_whole), torch.sqrt(param_whole)
    param_parts = _squares((floats[k].local for k in split if tx.counts_here(floats[k])), device)
    parts = torch.cat([param_parts[None], grad_parts])
    collectives.all_reduce(parts, tx.mesh.groups["model"])
    grad = grad_whole + parts[1] + parts[2 + tx.mesh.fsdp_index]
    return torch.sqrt(grad), torch.sqrt(param_whole + parts[0])
