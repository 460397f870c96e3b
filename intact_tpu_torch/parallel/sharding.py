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

The parameters (ZeRO-3 by the JAX package's DEFAULT_RULES, the serving
path): `spec_for_path` gives a leaf's spec, a tuple of axis names or None
per dimension, first match wins over the "/"-joined path; an axis whose mesh
size does not divide its dimension is dropped, and the tensor axis always is
(it is not ported: its size is 1). The port's int8 `kernel_q` is
[..., out, in], the transpose of the JAX package's [..., in, out], so a
`kernel_q` leaf takes its rule's spec with the last two entries swapped. At
fsdp > 1 `shard_tree` keeps this rank's slice of every leaf the rules shard
over fsdp as a `Sharded` holder (the slice, its dimension, the fsdp group);
the towers gather one at a time where they use it (`models/common.py`:
`layer` for the stacked blocks, `dense`, `embed_lookup`, `unembed_logits`),
so only one layer is ever whole. At fsdp 1 every leaf stays a plain tensor.
"""

from __future__ import annotations

import dataclasses
import re

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


def pad_rows(arrays: list, world: int) -> list:
    """Host arrays with a leading batch axis, each with its last row repeated
    up to a multiple of the world size, as the JAX package's sharded serving
    pads a batch over (data, fsdp)."""
    import numpy as np

    pad = -arrays[0].shape[0] % world
    return [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) if pad else a for a in arrays]


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



# ---------------------------------------------------------------------------
# the parameters over fsdp (ZeRO-3, gathered layer by layer)
# ---------------------------------------------------------------------------

# first match wins; paths are "/"-joined key paths like "vlm/blocks/attn/q/kernel"
# (intact_tpu/parallel/sharding.py's DEFAULT_RULES, specs as tuples)
DEFAULT_RULES: list[tuple[str, tuple]] = [
    # embeddings (embedding_q/embed_scale: int8 serving form, same layout)
    (r".*embed/embedding(_q)?$", ("tensor", "fsdp")),
    (r".*embed/embed_scale$", ("tensor",)),
    # AR unembedding (magma lm_head) [D, V]: contraction over fsdp
    (r".*lm_head/kernel(_q)?$", ("fsdp", "tensor")),
    # attention projections (stacked: leading layer axis)
    (r".*blocks/attn/[qkv]/kernel(_q)?$", (None, "fsdp", "tensor")),
    (r".*blocks/attn/o/kernel(_q)?$", (None, "tensor", "fsdp")),
    (r".*blocks/attn/[qkvo]/bias$", ()),
    # gated / vit MLPs
    (r".*blocks/mlp/(gate|up|fc1)/kernel(_q)?$", (None, "fsdp", "tensor")),
    (r".*blocks/mlp/(down|fc2)/kernel(_q)?$", (None, "tensor", "fsdp")),
    (r".*blocks/mlp/fc1/bias$", (None, "tensor")),
    # mvla expert self/cross pair stacks: the blocks' layout (leading pair axis)
    (r".*pairs/(self|cross)/attn/[qkv]/kernel(_q)?$", (None, "fsdp", "tensor")),
    (r".*pairs/(self|cross)/attn/o/kernel(_q)?$", (None, "tensor", "fsdp")),
    (r".*pairs/(self|cross)/mlp/(gate|up)/kernel(_q)?$", (None, "fsdp", "tensor")),
    (r".*pairs/(self|cross)/mlp/down/kernel(_q)?$", (None, "tensor", "fsdp")),
    # glue projections stay replicated: a few MB each
    (r".*(img_proj|time_mlp_in|time_mlp_out)/kernel$", ()),
    (r".*(state_proj|action_in_proj|action_out_proj)/kernel$", ()),
    # conv patch embed: output channels over tensor
    (r".*patch_embed/kernel$", (None, None, None, "tensor")),
    # everything else (norms, biases, pos_embed) replicated
    (r".*", ()),
]


def keystr(entry) -> str:
    """One path entry -> a plain string (a dict key, or an object's key, name or idx)."""
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return str(entry)


def _path_str(path) -> str:
    return "/".join(keystr(p) for p in path)


def _sanitize(spec: tuple, shape: tuple, mesh: Mesh) -> tuple:
    """One entry per dimension: an axis kept where its mesh size divides the
    dimension, None elsewhere; the tensor axis always goes (not ported)."""
    spec = tuple(spec)[:len(shape)]
    out = []
    for dim, axis in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        keep = axis is not None and axis != "tensor" and dim % mesh.shape[axis] == 0
        out.append(axis if keep else None)
    return tuple(out)


def spec_for_path(path_str: str, shape, mesh: Mesh, rules=None) -> tuple:
    """The leaf's spec on this mesh (the first matching rule, sanitized); a
    `kernel_q` leaf ([..., out, in] here) takes its rule with the last two
    entries swapped."""
    shape = tuple(shape)
    for pattern, spec in rules or DEFAULT_RULES:
        if re.match(pattern, path_str):
            if path_str.endswith("kernel_q") and len(shape) >= 2:
                spec = tuple(spec)[:len(shape)]
                spec = spec + (None,) * (len(shape) - len(spec))
                spec = spec[:-2] + (spec[-1], spec[-2])
            return _sanitize(spec, shape, mesh)
    return (None,) * len(shape)


def param_specs(params, mesh: Mesh, rules=None) -> dict:
    """A parameter tree (anything with .shape at the leaves) -> the tree of its specs."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return spec_for_path(_path_str(path), node.shape, mesh, rules)

    return walk(params, ())


@dataclasses.dataclass
class Sharded:
    """This rank's slice `local` of a leaf of shape `shape`, split in `parts`
    equal slices along `dim` over the fsdp `group` (rank order). Only
    `gather` makes it whole."""

    local: torch.Tensor
    dim: int
    shape: tuple
    group: object
    parts: int

    def gather(self, index=None) -> torch.Tensor:
        """The whole leaf, or `leaf[index]` for an index into the dimensions
        before `dim` (a layer of a stacked leaf, a range of rows): the group's
        slices concatenated along the split dimension, contiguous."""
        x = self.local if index is None else self.local[index]
        dim = self.dim - (self.local.ndim - x.ndim)
        if dim < 0 or x.shape[dim] != self.local.shape[self.dim]:
            raise ValueError(f"index {index!r} reaches the split dimension {self.dim} of a {self.shape} leaf")
        parts = all_gather_bytes(x, self.group, self.parts)  # [parts, *x.shape]
        if dim == 0:
            return parts.reshape(-1, *x.shape[1:])
        return torch.cat(list(parts.unbind(0)), dim=dim)


def shard_leaf(path: str, x: torch.Tensor, mesh: Mesh, put=None, rules=None):
    """A whole leaf -> this rank's: a `Sharded` slice where the rules split
    it over fsdp (fsdp > 1), else the leaf. `put` moves the (sliced) leaf to
    its device and dtype first; the slice never shares the whole leaf's storage."""
    spec = spec_for_path(path, x.shape, mesh, rules) if mesh.fsdp > 1 else ()
    if "fsdp" not in spec:
        return put(x) if put else x
    dim = spec.index("fsdp")
    n = x.shape[dim] // mesh.fsdp
    piece = x.narrow(dim, mesh.fsdp_index * n, n)
    local = put(piece.contiguous()) if put else piece
    if local.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        local = local.clone(memory_format=torch.contiguous_format)
    return Sharded(local, dim, tuple(x.shape), mesh.groups["fsdp"], mesh.fsdp)


def shard_tree(tree, mesh: Mesh, put=None, consume: bool = False, rules=None):
    """A whole parameter tree -> this rank's, leaf by leaf (`shard_leaf`).
    consume=True empties `tree` as it goes, so the whole leaves go as their
    slices are made."""
    def walk(node, path):
        if not isinstance(node, dict):
            return shard_leaf(_path_str(path), node, mesh, put, rules)
        out = {}
        for k in list(node):
            out[k] = walk(node[k], path + (k,))
            if consume:
                del node[k]
        return out

    return walk(tree, ())
