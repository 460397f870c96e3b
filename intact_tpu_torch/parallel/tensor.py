"""Megatron-style tensor parallelism: the regions' collectives (Pi0 at mesh.tensor > 1).

The rules (parallel/sharding.py) give each tensor rank a slice of the split
leaves: the output columns of the column-parallel products (q, gate, up,
fc1), the input rows of the row-parallel ones (o, down, fc2), the
vocabulary rows of the embedding. The towers find their tensor group in the
parameters they are handed (`of`: a `Sharded` leaf's `tensor`), so a tree
without tensor-split leaves runs as on one card, and a projection is split
only where its held shape says so (`region`). Megatron's two conventions, as
autograd Functions:

  f  `copy_in`: the input of a column-parallel region (the replicated x that
     every rank multiplies by its columns); identity forward, its gradient
     all-reduced over tensor in the backward (each rank's holds only its
     columns' part)
  g  `reduce_out`: the output of a row-parallel product (each rank's partial
     sum over its input rows); all-reduced over tensor in the forward,
     identity backward

and `vocab_lookup` (each rank looks up the ids in its rows, zeros
elsewhere, summed by g). Every collective is one
of parallel/collectives.py's tensor_* wrappers, counted there; without a
recorded gradient the forwards run the collective alone. A leaf replicated
over tensor whose use is partial (Pi0's K/V kernels, which every rank applies
for its own query heads only; SigLIP's q/k/v biases, sliced with their
columns) has a gradient that is one rank's part: the standard step sums it
over tensor (`partial_paths`, train/train_step.py).
"""

from __future__ import annotations

import dataclasses
import re

import torch

from intact_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the tensor axis: its group, the parts, its index."""

    group: object
    parts: int
    index: int

    def columns(self, n_local: int) -> slice:
        """This rank's slice of a dimension split in `parts` of n_local."""
        return slice(self.index * n_local, (self.index + 1) * n_local)


def of(tree) -> TensorParallel | None:
    """The tensor group of a parameter tree (or leaf): that of its first
    leaf split over tensor, None when none is."""
    from intact_tpu_torch.parallel.sharding import Sharded

    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(reversed(list(node.values())))
        elif isinstance(node, Sharded) and node.tensor is not None:
            t = node.tensor
            return TensorParallel(t.group, t.parts, t.index)
    return None


def out_features(p: dict) -> int:
    """A dense node's output width as held: `kernel` [..., in, out] or int8
    `kernel_q` [..., out, in]."""
    return p["kernel_q"].shape[-2] if "kernel_q" in p else p["kernel"].shape[-1]


def region(tp: TensorParallel | None, p: dict, full: int) -> TensorParallel | None:
    """`tp` where the column-parallel product `p` holds fewer than `full`
    output columns (the rules split it), None where it is whole."""
    return tp if tp is not None and out_features(p) < full else None


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):  # summed in fp32
        return collectives.tensor_all_reduce(grad.to(torch.float32, copy=True), ctx.group).to(grad.dtype), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return collectives.tensor_all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_in(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """f: the input of a column-parallel region (identity; the backward
    all-reduces its gradient over tensor)."""
    if tp is None or not _needs_grad(x):
        return x
    return _CopyIn.apply(x, tp.group)


def reduce_out(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """g: the sum over tensor of a row-parallel product's partials (a new
    tensor; identity backward)."""
    if tp is None:
        return x
    if _needs_grad(x):
        return _ReduceOut.apply(x, tp.group)
    return collectives.tensor_all_reduce(x.contiguous().clone(), tp.group)


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor, vocab: int, tp: TensorParallel) -> torch.Tensor:
    """Rows of a vocabulary-parallel table (this rank's `table` holds rows
    [index * n, (index + 1) * n) of `vocab`): ids clipped to the vocabulary,
    each rank's own rows looked up and the rest zero, summed over tensor."""
    n = table.shape[0]
    ids = ids.long().clamp(0, vocab - 1) - tp.index * n
    mine = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
    return reduce_out(rows, tp)


_PARTIAL = (
    # K/V kernels replicated over tensor (their heads do not split) beside split query heads
    re.compile(r"(.*?)/blocks/attn/[kv]/kernel(_q)?$"),
    # q/k/v biases, replicated by the rules and sliced with their columns at use
    re.compile(r"(.*?)/blocks/attn/[qkv]/bias$"),
)


def partial_paths(flat_params: dict) -> frozenset:
    """The leaves replicated over tensor whose gradient on a rank is its
    part only (summed over tensor by the optimizer): a tower's K/V kernels
    held whole beside its split q, and its q/k/v biases where their kernel
    is split."""
    from intact_tpu_torch.parallel.sharding import Sharded

    def split(path: str) -> bool:
        leaf = flat_params.get(path)
        return isinstance(leaf, Sharded) and leaf.tensor is not None

    out = set()
    for path, leaf in flat_params.items():
        if isinstance(leaf, Sharded) and leaf.tensor is not None:
            continue
        for pattern in _PARTIAL:
            m = pattern.match(path)
            if m is None:
                continue
            blocks = f"{m.group(1)}/blocks/attn"
            if pattern is _PARTIAL[0]:
                used_partially = any(split(f"{blocks}/q/{k}") for k in ("kernel", "kernel_q"))
            else:
                name = path.split("/")[-2]
                used_partially = any(split(f"{blocks}/{name}/{k}") for k in ("kernel", "kernel_q"))
            if used_partially:
                out.add(path)
    return frozenset(out)
