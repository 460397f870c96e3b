"""What the port shards, and how (intact_tpu/parallel/sharding.py's counterpart).

Two splits:
  * a leaf's GLOBAL block rows over the fsdp ranks (`RowShard`): a leaf of n
    elements is ceil(n / block) rows of `block` contiguous elements of its
    flattened form, the blocks of the 8-bit moments (train/optim8bit.py) and
    of the fused step's packed rows; rank f of the fsdp group owns rows
    [f * per, min((f + 1) * per, nb)), `per` being ceil(nb / fsdp) rounded up
    to `align` rows. Shares may be uneven or empty; the collectives pad them
    to `per` rows. A local shard is never re-blocked, so its absmax blocks
    and codes are one card's;
  * a batch's rows over the ranks (`local_rows`): rank r of a world of w
    holds rows [r * b / w, (r + 1) * b / w), as the JAX package's
    put_global_batch places a host's rows.

The gradient and parameter helpers run the collectives of
parallel/collectives.py, so the steps call them only when the mesh has a
process group (without one a rank's gradient is the mean, and its rows are
the leaf's): `mean_rows` (reduce-scatter over fsdp, all-reduce over data,
divided by the world size: the mean of the ranks' gradients), `mean_full`
(one all-reduce over the world) and `gather_rows` (all-gather of the updated
rows over fsdp, bit for bit). A world of one reduces nothing: its results
equal those of no group bit for bit.

The JAX package's DEFAULT_RULES (ZeRO-3 per-layer parameter sharding) have
no counterpart yet: every rank holds the whole parameters.
"""

from __future__ import annotations

import dataclasses

import torch

from intact_tpu_torch.parallel import collectives
from intact_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class RowShard:
    """Rows [r0, r1) of a leaf of n elements in rows of `block`, out of
    `parts` shares of `per` rows (the last ones short or empty)."""

    n: int
    block: int
    parts: int
    index: int
    per: int

    @property
    def nb(self) -> int:
        return -(-self.n // self.block)

    @property
    def r0(self) -> int:
        return min(self.index * self.per, self.nb)

    @property
    def r1(self) -> int:
        return min(self.r0 + self.per, self.nb)

    @property
    def rows(self) -> int:
        return self.r1 - self.r0

    @property
    def e0(self) -> int:
        return min(self.r0 * self.block, self.n)

    @property
    def e1(self) -> int:
        return min(self.r1 * self.block, self.n)

    @property
    def whole(self) -> bool:
        return self.parts == 1


def row_shard(n: int, block: int, parts: int, index: int, align: int = 1) -> RowShard:
    nb = -(-n // block)
    per = -(-(-(-nb // parts)) // align) * align
    return RowShard(n, block, parts, index, per)


def local_rows(tree, rank: int, world: int):
    """This rank's rows of a batch (a dict of arrays or tensors with a
    leading batch axis divisible by the world size)."""
    if isinstance(tree, dict):
        return {k: local_rows(v, rank, world) for k, v in tree.items()}
    b = tree.shape[0]
    if b % world:
        raise ValueError(f"a batch of {b} rows does not split over {world} ranks")
    per = b // world
    return tree[rank * per:(rank + 1) * per]


# ---------------------------------------------------------------------------
# gradients and parameters over the mesh
# ---------------------------------------------------------------------------

def mean_rows(g: torch.Tensor, shard: RowShard, mesh: Mesh) -> torch.Tensor:
    """fp32 [e1 - e0]: the mean over the world of the ranks' g, at this
    rank's rows (the mesh has a process group)."""
    flat = g.reshape(-1).to(torch.float32)
    size = shard.parts * shard.per * shard.block
    if flat.numel() == size:  # the shares tile the leaf: no padded copy
        padded = flat.contiguous()
    else:
        padded = torch.zeros(size, dtype=torch.float32, device=g.device)
        padded[:shard.n] = flat
    out = torch.empty(shard.per * shard.block, dtype=torch.float32, device=g.device)
    collectives.reduce_scatter(out, padded, mesh.groups["fsdp"])
    collectives.all_reduce(out, mesh.groups["data"])
    return out[:shard.e1 - shard.e0] / mesh.size


def mean_full(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """fp32, g's shape: the mean over the world of the ranks' g (the mesh has
    a process group)."""
    out = g.to(torch.float32, copy=True)
    collectives.all_reduce(out, mesh.groups["world"])
    return out / mesh.size


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(-1).view(torch.uint8)


def all_gather_bytes(x: torch.Tensor, group, parts: int) -> torch.Tensor:
    """The group's x (equal shapes), concatenated along a new leading axis
    [parts, *x.shape], bit for bit (gathered as bytes: fp8 and bool too)."""
    out = torch.empty(parts * x.numel() * x.element_size(), dtype=torch.uint8, device=x.device)
    collectives.all_gather(out, _as_bytes(x), group)
    return out.view(x.dtype).view(parts, *x.shape)


def gather_rows(flat_p: torch.Tensor, shard: RowShard, mesh: Mesh) -> None:
    """Copy every fsdp rank's rows of a flattened leaf (a view of its storage)
    into it, after each rank updated its own rows (the mesh has a process
    group)."""
    local = torch.zeros(shard.per * shard.block, dtype=flat_p.dtype, device=flat_p.device)
    local[:shard.e1 - shard.e0] = flat_p[shard.e0:shard.e1]
    full = all_gather_bytes(local, mesh.groups["fsdp"], shard.parts).view(-1)
    flat_p.copy_(full[:shard.n])


def gather_leading(x: torch.Tensor, mesh: Mesh, total: int, axis: int = 0) -> torch.Tensor:
    """Concatenate the fsdp ranks' equal local slices of a state tensor along
    `axis` (rank order) and keep the first `total` entries: the global layout
    of a row-sharded state tensor. A copy of x without a process group."""
    if not mesh.distributed:
        return x.narrow(axis, 0, total).clone()
    parts = all_gather_bytes(x, mesh.groups["fsdp"], mesh.fsdp)  # [F, *x.shape]
    return torch.cat(list(parts.unbind(0)), dim=axis).narrow(axis, 0, total)


def take_leading(x: torch.Tensor, shard: RowShard, per_axis: int, axis: int = 0) -> torch.Tensor:
    """This rank's zero-padded slice of a global state tensor along `axis`:
    `per_axis` entries from index * per_axis (the inverse of gather_leading)."""
    start = min(shard.index * per_axis, x.shape[axis])
    stop = min(start + per_axis, x.shape[axis])
    shape = list(x.shape)
    shape[axis] = per_axis
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(axis, 0, stop - start).copy_(x.narrow(axis, start, stop - start))
    return out


def data_draw_key(seed: int, step: int, mesh: Mesh) -> tuple:
    """The numpy key of this rank's random draws at a micro-step: (seed, step)
    on one rank, (seed, step, rank) on several, so ranks draw their own rows'
    noise."""
    return (seed, step) if mesh.size == 1 else (seed, step, mesh.rank)

