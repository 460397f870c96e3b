"""The collectives the port issues, each counting its calls.

Thin wrappers over torch.distributed's all_reduce (sum, or max:
`all_reduce_max`), reduce_scatter_tensor (sum), all_gather_into_tensor and
broadcast on a process group: the fsdp group, the data group or the world
(parallel/mesh.py). The ZeRO-3 layer buckets (parallel/sharding.py) have
their own two: `bucket_all_gather` (a packed byte buffer) and
`bucket_reduce_scatter` (a packed fp32 buffer into a given output, as a sum).
The tensor group (parallel/mesh.py, parallel/tensor.py) has its own three,
counted apart so a run reads its tensor-parallel traffic: `tensor_all_reduce`
(sum), `tensor_all_reduce_max` and `tensor_all_gather` (the serving group's
broadcasts go over the world).
NCCL carries them on the card, gloo on the CPU; they are library calls, as
XLA's collectives are for the JAX package. Each wrapper adds one to its
`.calls` where it issues its collective, and nowhere else, as the kernels'
wrappers count `.launches`: `counts()` reads all ten, and `reset()` sets
them to 0. Nothing catches a failed collective.

One rule stages tensors through the host: a CUDA tensor on a gloo group (two
ranks on one card, where NCCL refuses a second rank of the same device, run
their groups on gloo) is copied to the host, reduced or gathered there and
copied back (`_on_host`, into page-locked buffers kept per size: the shapes
repeat layer after layer), and `staged_calls()` counts those collectives.
No other group and no other device is staged, and nothing retries a failed
call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _op(name: str, older: str):
    """torch.distributed's `name`, or its older name: torch 2.13 renamed the
    tensor collectives and deprecated the old names, which older releases
    have alone."""
    return getattr(dist, name, None) or getattr(dist, older)


def staged(x: torch.Tensor, group) -> bool:
    """The staging rule: a CUDA tensor on a gloo group goes through the host."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


_PINNED: dict = {}  # (role, bytes) -> a page-locked host buffer the staged collectives reuse


def _host(x: torch.Tensor, role: str) -> torch.Tensor:
    """A host copy of x: in a page-locked buffer kept for its role and size
    where x is on the card, else x.cpu()."""
    if not x.is_cuda:
        return x.cpu()
    key = (role, x.numel() * x.element_size())
    if key not in _PINNED:
        _PINNED[key] = torch.empty(key[1], dtype=torch.uint8, pin_memory=True)
    return _PINNED[key].view(x.dtype).view(x.shape).copy_(x)


def _on_host(fn, inputs: list, outputs: list) -> None:
    """fn(*host copies of inputs and outputs), then each output copied back
    in place: one staged collective."""
    host_in = [_host(x, f"in{i}") for i, x in enumerate(inputs)]
    host_out = [_host(x, f"out{i}") for i, x in enumerate(outputs)]
    fn(*host_out, *host_in)
    for x, h in zip(outputs, host_out):
        x.copy_(h)
    _on_host.calls += 1


def _all_reduce(x, group, op=None) -> None:
    kw = {} if op is None else {"op": op}
    if staged(x, group):
        _on_host(lambda h: dist.all_reduce(h, group=group, **kw), [], [x])
    else:
        dist.all_reduce(x, group=group, **kw)


def _into(name: str, older: str, out, x, group) -> None:
    fn = _op(name, older)
    if staged(x, group):
        _on_host(lambda o, i: fn(o, i, group=group), [x], [out])
    else:
        fn(out, x, group=group)


def _broadcast(x, group, src: int) -> None:
    if staged(x, group):
        _on_host(lambda h: dist.broadcast(h, src=src, group=group), [], [x])
    else:
        dist.broadcast(x, src=src, group=group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """x <- the sum of x over the group's ranks, in place."""
    _all_reduce(x, group)
    all_reduce.calls += 1
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """x <- the elementwise max of x over the group's ranks, in place."""
    _all_reduce(x, group, dist.ReduceOp.MAX)
    all_reduce_max.calls += 1
    return x


def reduce_scatter(out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """out <- the sum over the group's ranks of this rank's chunk of x (x holds
    group-size equal chunks, in rank order)."""
    _into("reduce_scatter_single", "reduce_scatter_tensor", out, x, group)
    reduce_scatter.calls += 1
    return out


def all_gather(out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """out <- the ranks' x, concatenated in rank order along the first axis."""
    _into("all_gather_single", "all_gather_into_tensor", out, x, group)
    all_gather.calls += 1
    return out


def bucket_all_gather(out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """out <- the ranks' packed byte buffers x, concatenated in rank order (a
    layer bucket's gather)."""
    _into("all_gather_single", "all_gather_into_tensor", out, x, group)
    bucket_all_gather.calls += 1
    return out


def bucket_reduce_scatter(out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """out <- the sum over the group's ranks of this rank's chunk of the packed
    buffer x (a layer bucket's gradient reduce-scatter)."""
    _into("reduce_scatter_single", "reduce_scatter_tensor", out, x, group)
    bucket_reduce_scatter.calls += 1
    return out


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """x <- the group's rank `src`'s x (global rank), in place."""
    _broadcast(x, group, src)
    broadcast.calls += 1
    return x


def tensor_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """x <- the sum of x over the tensor group, in place (a row-parallel
    product's partials, a column-parallel region's input gradient)."""
    _all_reduce(x, group)
    tensor_all_reduce.calls += 1
    return x


def tensor_all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """x <- the elementwise max of x over the tensor group, in place (a
    row-parallel int8 product's row absmax)."""
    _all_reduce(x, group, dist.ReduceOp.MAX)
    tensor_all_reduce_max.calls += 1
    return x


def tensor_all_gather(out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """out <- the tensor group's x, concatenated in rank order along the first axis."""
    _into("all_gather_single", "all_gather_into_tensor", out, x, group)
    tensor_all_gather.calls += 1
    return out


WRAPPERS = (all_reduce, all_reduce_max, reduce_scatter, all_gather, bucket_all_gather, bucket_reduce_scatter,
            broadcast, tensor_all_reduce, tensor_all_reduce_max, tensor_all_gather)


def counts() -> dict[str, int]:
    """The calls of the ten collectives since the last reset() (the staged
    ones among them: `staged_calls()`)."""
    return {f.__name__: f.calls for f in WRAPPERS}


def staged_calls() -> int:
    """The collectives staged through the host since the last reset()."""
    return _on_host.calls


def reset() -> None:
    for f in WRAPPERS + (_on_host,):
        f.calls = 0


reset()
