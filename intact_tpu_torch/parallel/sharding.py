"""What the port shards, and how (intact_tpu/parallel/sharding.py's counterpart).

Two splits:
  * a leaf's GLOBAL block rows over the fsdp ranks (`RowShard`, the fused
    step's ZeRO-2): a leaf of n elements is ceil(n / block) rows of `block`
    contiguous elements of its flattened form, the blocks of the fused
    step's packed rows and 8-bit moments; rank f of the fsdp group owns rows
    [f * per, min((f + 1) * per, nb)), `per` being ceil(nb / fsdp) rounded up
    to `align` rows. Shares may be uneven or empty; the collectives pad them
    to `per` rows. A local shard is never re-blocked, so its absmax blocks
    and codes are one card's;
  * a batch's rows over the batch coordinates (`local_rows`): coordinate c
    of w (a rank's d * fsdp + f, `Mesh.batch_index`: the tensor ranks of one
    coordinate take the same rows) holds rows [c * b / w, (c + 1) * b / w),
    as the JAX package's put_global_batch places a host's rows over (data,
    fsdp).

The gradient and parameter helpers run the collectives of
parallel/collectives.py, so the steps call them only when the mesh has a
process group (without one a rank's gradient is the mean, and its rows are
the leaf's): the fused step's `mean_rows` (reduce-scatter over the model
group, fsdp x tensor, all-reduce over data, divided by the batch
coordinates: the mean of the coordinates' gradients, each summed over its
tensor ranks' parts) and `gather_rows` (all-gather of the updated rows over
the model group, bit for bit), and `mean_full` (one all-reduce over the
world: the standard step's replicated leaves). At tensor 1 the model group
is the fsdp group and the batch coordinates are the world. A world of one
reduces nothing: its results equal those of no group bit for bit.

The parameters (ZeRO-3 by the JAX package's DEFAULT_RULES: serving and the
standard training step): `spec_for_path` gives a leaf's spec, a tuple of
axis names or None per dimension, first match wins over the "/"-joined path;
an axis whose mesh size does not divide its dimension is dropped (the leaf
stays whole and replicated over it). The tensor axis is kept at tensor > 1
only where it divides, and on an attention projection only where it divides
the projection's heads (`heads`: {tower: (query heads, K/V heads)}, from the
model; without it the projections stay replicated over tensor): Pi0's one
K/V head keeps its k and v whole on every tensor rank, where the JAX rule
would split their head_dim. At tensor 1 the axis is dropped. The port's int8
`kernel_q` is [..., out, in], the transpose of the JAX package's [..., in,
out], so a `kernel_q` leaf takes its rule's spec with the last two entries
swapped. `shard_tree` keeps this rank's part of every leaf the rules split
over fsdp or tensor as a `Sharded` holder: the tensor rank's slice of the
leaf (Megatron's column, row or vocabulary part: `Sharded.tensor`), that
slice's fsdp part (ZeRO-3: its dimension, the fsdp group, its part, and
where it trains its local gradient). The towers gather one layer at a time
where they use it (`models/common.py`: `layer` for the stacked blocks,
`dense`, `embed_lookup`, `unembed_logits`, `whole`) over fsdp only, so only
one layer of the tensor slice is ever whole; a leaf split over tensor alone
is used as it is held. A layer's fsdp-split leaves travel as one bucket:
their slices packed into one byte buffer at 128-byte aligned offsets and
gathered with one all-gather, each leaf unpacked into a contiguous tensor of
its own (`gather_bucket`); where they train, `GatherLayer`'s backward packs
their whole gradients rank-major into one fp32 buffer and reduce-scatters it
with one collective, adding each part into the leaf's local gradient at the
layer (`reduce_scatter_bucket`). The bucket gather, its unpack and the
reduce-scatter are `torch.profiler.record_function` ranges ("bucket
gather", "bucket unpack", "bucket reduce-scatter"). At fsdp 1 and tensor 1
every leaf stays a plain tensor.
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
    """Batch coordinate `rank`'s rows of a batch (a dict of arrays or tensors
    with a leading batch axis divisible by `world`, the coordinates: a
    mesh's batch_index and batch_size)."""
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
    """fp32 [e1 - e0]: the ranks' g summed over the model group (fsdp x
    tensor: `shard` splits the rows over it) and over data, divided by the
    batch coordinates, at this rank's rows (the mesh has a process group).
    Where a tensor rank's g holds its part of the leaf and zeros elsewhere,
    that is the mean over the coordinates of their whole gradients."""
    flat = g.reshape(-1).to(torch.float32)
    size = shard.parts * shard.per * shard.block
    if flat.numel() == size:  # the shares tile the leaf: no padded copy
        padded = flat.contiguous()
    else:
        padded = torch.zeros(size, dtype=torch.float32, device=g.device)
        padded[:shard.n] = flat
    out = torch.empty(shard.per * shard.block, dtype=torch.float32, device=g.device)
    collectives.reduce_scatter(out, padded, mesh.groups["model"])
    collectives.all_reduce(out, mesh.groups["data"])
    return out[:shard.e1 - shard.e0] / mesh.batch_size


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
    """Copy every model-group rank's rows of a flattened leaf (a view of its
    storage) into it, after each rank updated its own rows (the mesh has a
    process group)."""
    local = torch.zeros(shard.per * shard.block, dtype=flat_p.dtype, device=flat_p.device)
    local[:shard.e1 - shard.e0] = flat_p[shard.e0:shard.e1]
    full = all_gather_bytes(local, mesh.groups["model"], shard.parts).view(-1)
    flat_p.copy_(full[:shard.n])


def gather_leading(x: torch.Tensor, mesh: Mesh, total: int, axis: int = 0) -> torch.Tensor:
    """Concatenate the model group's (fsdp x tensor) equal local slices of a
    state tensor along `axis` (rank order) and keep the first `total`
    entries: the global layout of a row-sharded state tensor. A copy of x
    without a process group."""
    if not mesh.distributed:
        return x.narrow(axis, 0, total).clone()
    parts = all_gather_bytes(x, mesh.groups["model"], mesh.fsdp * mesh.tensor)  # [F * T, *x.shape]
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
    with one batch coordinate, (seed, step, d * fsdp + f) with several, so
    each coordinate draws its own rows' noise and the tensor ranks of one
    coordinate draw the same."""
    return (seed, step) if mesh.batch_size == 1 else (seed, step, mesh.batch_index)



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


_PROJECTION = re.compile(r"(.*?)/(?:blocks|pairs/(?:self|cross))/attn/([qkvo])/kernel(?:_q)?$")


def _tensor_units(path_str: str, dim: int, heads) -> int:
    """What the tensor axis must divide on a leaf's dimension: an attention
    projection's heads (query heads for q and o, K/V heads for k and v; 0,
    which nothing divides, without `heads` for its tower), else the
    dimension itself. The patch embed's kernel takes 0: the towers use the
    whole embedded image on every tensor rank, so its channels stay whole."""
    if path_str.endswith("patch_embed/kernel"):
        return 0
    m = _PROJECTION.match(path_str)
    if m is None:
        return dim
    tower, name = m.groups()
    if not heads or tower not in heads:
        return 0
    q_heads, kv_heads = heads[tower]
    return kv_heads if name in "kv" else q_heads


def _sanitize(spec: tuple, shape: tuple, mesh: Mesh, path_str: str = "", heads=None) -> tuple:
    """One entry per dimension: an axis kept where its mesh size divides the
    dimension (the tensor axis: at tensor > 1, and on an attention projection
    where it divides the heads), None elsewhere."""
    spec = tuple(spec)[:len(shape)]
    out = []
    for dim, axis in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        keep = axis is not None and dim % mesh.shape[axis] == 0
        if axis == "tensor":
            units = _tensor_units(path_str, dim, heads)
            keep = keep and mesh.tensor > 1 and units > 0 and units % mesh.tensor == 0
        out.append(axis if keep else None)
    return tuple(out)


def spec_for_path(path_str: str, shape, mesh: Mesh, rules=None, heads=None) -> tuple:
    """The leaf's spec on this mesh (the first matching rule, sanitized); a
    `kernel_q` leaf ([..., out, in] here) takes its rule with the last two
    entries swapped. `heads`: {tower: (query heads, K/V heads)} for the
    tensor axis on attention projections."""
    shape = tuple(shape)
    for pattern, spec in rules or DEFAULT_RULES:
        if re.match(pattern, path_str):
            if path_str.endswith("kernel_q") and len(shape) >= 2:
                spec = tuple(spec)[:len(shape)]
                spec = spec + (None,) * (len(shape) - len(spec))
                spec = spec[:-2] + (spec[-1], spec[-2])
            return _sanitize(spec, shape, mesh, path_str, heads)
    return (None,) * len(shape)


def param_specs(params, mesh: Mesh, rules=None, heads=None) -> dict:
    """A parameter tree (anything with .shape at the leaves) -> the tree of its specs."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return spec_for_path(_path_str(path), node.shape, mesh, rules, heads)

    return walk(params, ())


@dataclasses.dataclass(frozen=True)
class TensorSplit:
    """A leaf split over the tensor axis: `parts` equal slices along `dim` of
    the whole leaf of shape `shape`, over the tensor `group` (rank order);
    `index` is this rank's."""

    dim: int
    parts: int
    index: int
    group: object
    shape: tuple


@dataclasses.dataclass(eq=False)
class Sharded:
    """This rank's part `local` of a leaf: of its tensor slice (`tensor`, or
    the whole leaf without one) of shape `shape`, split in `parts` equal
    slices along `dim` over the fsdp `group` (rank order); `index` is this
    rank's fsdp part (group None: the tensor slice is held whole).
    Only a bucket gather (`gather_tree`, `gather_leaf`) makes the fsdp parts
    whole; `gather_leaf` also joins the tensor slices. `grad`, where a leaf
    split over fsdp trains, is the local gradient the bucket reduce-scatters
    add into (train/train_step.py)."""

    local: torch.Tensor
    dim: int
    shape: tuple
    group: object
    parts: int
    index: int = 0
    grad: torch.Tensor | None = None
    tensor: TensorSplit | None = None

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def requires_grad(self) -> bool:
        return self.local.requires_grad

    @property
    def fsdp_split(self) -> bool:
        """Held over an fsdp group (as its parts, one part included), where a
        leaf split over tensor alone has none."""
        return self.group is not None

    @property
    def whole_shape(self) -> tuple:
        """The whole leaf's shape (over fsdp and tensor)."""
        return self.tensor.shape if self.tensor is not None else self.shape

    def numel(self) -> int:
        """The elements of the tensor slice (the leaf's, without one)."""
        return self.local.numel() * self.parts

    def whole_numel(self) -> int:
        return self.numel() * (self.tensor.parts if self.tensor is not None else 1)

    def is_floating_point(self) -> bool:
        return self.local.is_floating_point()

    def with_local(self, local: torch.Tensor, grad: torch.Tensor | None = None) -> "Sharded":
        return dataclasses.replace(self, local=local, grad=grad)


# ---------------------------------------------------------------------------
# layer buckets: one collective per layer
# ---------------------------------------------------------------------------

ALIGN = 128  # each leaf's offset in a bucket, in bytes: an aligned view for every dtype


def _aligned(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


def _layer_slices(leaves: list, index) -> tuple[list, list]:
    """Each leaf's local slice at `index` and the split dimension in it."""
    xs, dims = [], []
    for s in leaves:
        x = s.local if index is None else s.local[index]
        dim = s.dim - (s.local.ndim - x.ndim)
        if dim < 0 or x.shape[dim] != s.local.shape[s.dim]:
            raise ValueError(f"index {index!r} reaches the split dimension {s.dim} of a {s.shape} leaf")
        xs.append(x)
        dims.append(dim)
    group, parts = leaves[0].group, leaves[0].parts
    if any(s.group is not group or s.parts != parts for s in leaves):
        raise ValueError("a bucket's leaves must share one group and one split")
    return xs, dims


def gather_bucket(leaves: list, index=None, all_gather=None) -> list[torch.Tensor]:
    """The leaves whole (at `index`): their local slices packed into one byte
    buffer, each at a 128-byte aligned offset, gathered over the group with
    one all-gather (`all_gather`, the bucket's own by default), and unpacked
    leaf by leaf into a tensor of its own (the parts concatenated along the
    split dimension, contiguous)."""
    from torch.profiler import record_function

    xs, dims = _layer_slices(leaves, index)
    group, parts = leaves[0].group, leaves[0].parts
    with record_function("bucket gather"):
        offsets, size = [], 0
        for x in xs:
            offsets.append(size)
            size += _aligned(x.numel() * x.element_size())
        send = torch.empty(size, dtype=torch.uint8, device=xs[0].device)
        for x, o in zip(xs, offsets):
            send[o:o + x.numel() * x.element_size()].view(x.dtype).view(x.shape).copy_(x)
        recv = torch.empty(parts * size, dtype=torch.uint8, device=send.device)
        (all_gather or collectives.bucket_all_gather)(recv, send, group)
    with record_function("bucket unpack"):
        out = []
        for x, dim, o in zip(xs, dims, offsets):
            n = x.numel() * x.element_size()
            pieces = [recv[r * size + o:r * size + o + n].view(x.dtype).view(x.shape) for r in range(parts)]
            out.append(torch.cat(pieces, dim=dim))
    return out


def reduce_scatter_bucket(leaves: list, index, grads: list) -> list[torch.Tensor]:
    """The reverse of gather_bucket for the gradients of whole leaves (each
    grads[j] shaped as leaves[j] whole at `index`): each gradient split into
    its parts, packed rank-major into one fp32 buffer (each leaf at a 128-byte
    aligned offset) and reduce-scattered as a sum with one collective ->
    this rank's part of each, fp32, summed over the group."""
    from torch.profiler import record_function

    xs, dims = _layer_slices(leaves, index)
    group, parts = leaves[0].group, leaves[0].parts
    with record_function("bucket reduce-scatter"):
        offsets, size = [], 0
        for x in xs:
            offsets.append(size)
            size += _aligned(x.numel() * 4) // 4
        send = torch.empty(parts * size, dtype=torch.float32, device=grads[0].device)
        for x, dim, o, g in zip(xs, dims, offsets, grads):
            for r, piece in enumerate(g.chunk(parts, dim=dim)):
                send[r * size + o:r * size + o + x.numel()].view(x.shape).copy_(piece)
        recv = torch.empty(size, dtype=torch.float32, device=send.device)
        collectives.bucket_reduce_scatter(recv, send, group)
    return [recv[o:o + x.numel()].view(x.shape) for x, o in zip(xs, offsets)]


class GatherLayer(torch.autograd.Function):
    """A layer's split leaves whole, as one bucket: forward = the bucket's
    all-gather; backward = the bucket's reduce-scatter of the trainable
    leaves' gradients, added straight into each leaf's local gradient at
    `index` (`Sharded.grad`), so no whole-size gradient of a stacked leaf is
    ever formed; it returns no gradient to its inputs. Every rank takes each
    layer's gather in the same order, and a leaf whose whole gradient is
    undefined on a rank takes part with zeros."""

    @staticmethod
    def forward(ctx, leaves, index, *locals_):
        ctx.leaves, ctx.index = leaves, index
        return tuple(gather_bucket(leaves, index))

    @staticmethod
    def backward(ctx, *grads):
        train = [j for j, s in enumerate(ctx.leaves) if ctx.needs_input_grad[2 + j]]
        if train:
            leaves = [ctx.leaves[j] for j in train]
            parts = reduce_scatter_bucket(leaves, ctx.index, [grads[j] for j in train])
            for s, part in zip(leaves, parts):
                if s.grad is None:
                    s.grad = torch.zeros_like(s.local)
                dst = s.grad if ctx.index is None else s.grad[ctx.index]
                dst.add_(part)
        return (None, None) + (None,) * len(ctx.leaves)


def gather_layer(leaves: list, index=None) -> list[torch.Tensor]:
    """The leaves whole at `index` through one bucket: through GatherLayer
    where a gradient is recorded and a leaf trains, the plain bucket gather
    otherwise (no_grad, inference_mode, frozen leaves)."""
    if torch.is_grad_enabled() and any(s.local.requires_grad for s in leaves):
        return list(GatherLayer.apply(leaves, index, *(s.local for s in leaves)))
    return gather_bucket(leaves, index)


def gather_tree(tree, index=None):
    """A (nested dict) tree with its fsdp-split `Sharded` leaves whole over
    fsdp (at `index`), all of them through one bucket; a leaf split over
    tensor alone as this rank holds it, the other leaves as they are
    (`x[index]`)."""
    flat = dict(_flat_items(tree))
    for path, x in flat.items():
        if isinstance(x, Sharded) and not x.fsdp_split:
            flat[path] = x.local
    sharded = [path for path, x in flat.items() if isinstance(x, Sharded)]
    whole = dict(zip(sharded, gather_layer([flat[p] for p in sharded], index))) if sharded else {}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path in whole:
            return whole[path]
        node = flat[path]
        return node if index is None else node[index]

    return walk(tree, ())


def _flat_items(tree, path=()) -> list:
    if isinstance(tree, dict):
        return [item for k, v in tree.items() for item in _flat_items(v, path + (k,))]
    return [(path, tree)]


def held(p) -> torch.Tensor:
    """The tensor a rank holds of a leaf: a `Sharded` leaf's slice, else the leaf."""
    return p.local if isinstance(p, Sharded) else p


def gather_leaf(x: torch.Tensor, like: Sharded) -> torch.Tensor:
    """A local tensor laid out as `like`'s part (the leaf's own, a moment's
    codes, an accumulator) -> the whole tensor: gathered over its fsdp group,
    then its tensor slices joined over the tensor group."""
    if like.fsdp_split:
        x = gather_bucket([dataclasses.replace(like, local=x, grad=None)])[0]
    t = like.tensor
    if t is None:
        return x
    out = torch.empty(t.parts * x.numel() * x.element_size(), dtype=torch.uint8, device=x.device)
    collectives.tensor_all_gather(out, _as_bytes(x), t.group)
    return torch.cat(list(out.view(x.dtype).view(t.parts, *x.shape).unbind(0)), dim=t.dim)


def take_slice(whole: torch.Tensor, like: Sharded) -> torch.Tensor:
    """A whole tensor shaped as `like`'s leaf -> this rank's part of it (a
    view: the tensor slice's fsdp part; `whole` may live on the host)."""
    t = like.tensor
    if t is not None:
        n = whole.shape[t.dim] // t.parts
        whole = whole.narrow(t.dim, t.index * n, n)
    n = whole.shape[like.dim] // like.parts
    return whole.narrow(like.dim, like.index * n, n)


def shard_leaf(path: str, x: torch.Tensor, mesh: Mesh, put=None, rules=None, heads=None, over_fsdp: bool = True):
    """A whole leaf -> this rank's: a `Sharded` part where the rules split it
    over fsdp (fsdp > 1; not without `over_fsdp`: the leaf stays whole over
    fsdp, as the fused step's ZeRO-2 keeps it) or tensor (tensor > 1; `heads`
    as for spec_for_path), else the leaf. `put` moves the (sliced) leaf to
    its device and dtype first; the part never shares the whole leaf's
    storage."""
    spec = spec_for_path(path, x.shape, mesh, rules, heads) if mesh.fsdp > 1 or mesh.tensor > 1 else ()
    fsdp = "fsdp" in spec and mesh.fsdp > 1 and over_fsdp
    if not fsdp and "tensor" not in spec:
        return put(x) if put else x
    piece, tensor = x, None
    if "tensor" in spec:
        tdim = spec.index("tensor")
        n = x.shape[tdim] // mesh.tensor
        piece = x.narrow(tdim, mesh.tensor_index * n, n)
        tensor = TensorSplit(tdim, mesh.tensor, mesh.tensor_index, mesh.groups["tensor"], tuple(x.shape))
    shape = tuple(piece.shape)
    dim, group, parts, index = 0, None, 1, 0
    if fsdp:
        dim, group, parts, index = spec.index("fsdp"), mesh.groups["fsdp"], mesh.fsdp, mesh.fsdp_index
        n = piece.shape[dim] // parts
        piece = piece.narrow(dim, index * n, n)
    local = put(piece.contiguous()) if put else piece
    if local.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        local = local.clone(memory_format=torch.contiguous_format)
    return Sharded(local, dim, shape, group, parts, index, tensor=tensor)


def shard_tree(tree, mesh: Mesh, put=None, consume: bool = False, rules=None, heads=None, over_fsdp: bool = True):
    """A whole parameter tree -> this rank's, leaf by leaf (`shard_leaf`).
    consume=True empties `tree` as it goes, so the whole leaves go as their
    slices are made."""
    def walk(node, path):
        if not isinstance(node, dict):
            return shard_leaf(_path_str(path), node, mesh, put, rules, heads, over_fsdp)
        out = {}
        for k in list(node):
            out[k] = walk(node[k], path + (k,))
            if consume:
                del node[k]
        return out

    return walk(tree, ())
