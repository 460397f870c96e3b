"""The collectives the port issues, each counting its calls.

Thin wrappers over torch.distributed's all_reduce (sum, or max:
`all_reduce_max`), reduce_scatter_tensor (sum), all_gather_into_tensor and
broadcast on a process group: the fsdp group, the data group or the world
(parallel/mesh.py). The ZeRO-3 layer buckets (parallel/sharding.py) have
their own two: `bucket_all_gather` (a packed byte buffer) and
`bucket_reduce_scatter` (a packed fp32 buffer into a given output, as a sum).
NCCL carries them on the card, gloo on the CPU; they are library calls, as
XLA's collectives are for the JAX package. Each wrapper adds one to its
`.calls` where it issues its collective, and nowhere else, as the kernels'
wrappers count `.launches`: `counts()` reads all seven, and `reset()` sets
them to 0. Nothing catches a failed collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _op(name: str, older: str):
    """torch.distributed's `name`, or its older name: torch 2.13 renamed the
    tensor collectives and deprecated the old names, which older releases
    have alone."""
    return getattr(dist, name, None) or getattr(dist, older)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """x <- the sum of x over the group's ranks, in place."""
    dist.all_reduce(x, group=group)
    all_reduce.calls += 1
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """x <- the elementwise max of x over the group's ranks, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    all_reduce_max.calls += 1
    return x


def reduce_scatter(out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """out <- the sum over the group's ranks of this rank's chunk of x (x holds
    group-size equal chunks, in rank order)."""
    _op("reduce_scatter_single", "reduce_scatter_tensor")(out, x, group=group)
    reduce_scatter.calls += 1
    return out


def all_gather(out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """out <- the ranks' x, concatenated in rank order along the first axis."""
    _op("all_gather_single", "all_gather_into_tensor")(out, x, group=group)
    all_gather.calls += 1
    return out


def bucket_all_gather(out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """out <- the ranks' packed byte buffers x, concatenated in rank order (a
    layer bucket's gather)."""
    _op("all_gather_single", "all_gather_into_tensor")(out, x, group=group)
    bucket_all_gather.calls += 1
    return out


def bucket_reduce_scatter(out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """out <- the sum over the group's ranks of this rank's chunk of the packed
    buffer x (a layer bucket's gradient reduce-scatter)."""
    _op("reduce_scatter_single", "reduce_scatter_tensor")(out, x, group=group)
    bucket_reduce_scatter.calls += 1
    return out


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """x <- the group's rank `src`'s x (global rank), in place."""
    dist.broadcast(x, src=src, group=group)
    broadcast.calls += 1
    return x


WRAPPERS = (all_reduce, all_reduce_max, reduce_scatter, all_gather, bucket_all_gather, bucket_reduce_scatter,
            broadcast)


def counts() -> dict[str, int]:
    """The calls of the seven collectives since the last reset()."""
    return {f.__name__: f.calls for f in WRAPPERS}


def reset() -> None:
    for f in WRAPPERS:
        f.calls = 0


reset()
