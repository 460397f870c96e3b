"""Megatron-style tensor parallelism: the regions' collectives (mesh.tensor > 1).

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

and the vocabulary-parallel pieces of the token-decoding families:
`vocab_lookup` (each rank looks up the ids in its rows of a float or int8
table, zeros elsewhere, summed by g: one non-zero term, so exact),
`vocab_window` (a rank's rows of a window of the vocabulary, Pi0FAST's
action tail), `vocab_argmax` (the first index of the maximum over logits
split over tensor, as argmax over the whole: one MAX all-reduce of a packed
int64 per row) and `vocab_cross_entropy` (Megatron's vocabulary-parallel
cross entropy, Pi0FAST's training loss: one MAX all-reduce and one sum
all-reduce per call, the gradient softmax - one-hot on the rank's columns). `kv_heads` gives the K/V heads a rank's query heads read
where the K/V heads do not split, `whole_groups` pads a rank's query heads
to whole groups of one K/V head. Every collective is one
of parallel/collectives.py's tensor_* wrappers, counted there; without a
recorded gradient the forwards run the collective alone. A leaf replicated
over tensor whose use is partial (the one-head K/V kernels of Pi0's towers
and of MVLA's expert pairs, which every rank applies for its own query heads
only; SigLIP's and the DiT's q/k/v biases, sliced with their columns; the
connector's per-head q/k norm scales) has a gradient that is one rank's
part: the standard step sums it over tensor (`partial_paths`,
train/train_step.py).
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn.functional as F

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


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor, vocab: int, tp: TensorParallel,
                 scale: torch.Tensor | None = None) -> torch.Tensor:
    """Rows of a vocabulary-parallel table (this rank's `table` holds rows
    [index * n, (index + 1) * n) of `vocab`): ids clipped to the vocabulary,
    each rank's own rows looked up and the rest zero, summed over tensor.
    An int8 table (`scale`: this rank's per-row scales) gives its rows as
    fp32 codes times scales, one card's products: the sum over tensor has one
    non-zero term, so it is exact."""
    n = table.shape[0]
    ids = ids.long().clamp(0, vocab - 1) - tp.index * n
    mine = (ids >= 0) & (ids < n)
    local = ids.clamp(0, n - 1)
    rows = table[local]
    if scale is not None:
        rows = rows.to(torch.float32) * scale[local].to(torch.float32)[..., None]
    return reduce_out(torch.where(mine[..., None], rows, rows.new_zeros(())), tp)


def vocab_window(tp: TensorParallel | None, rows: int, first: int) -> tuple[int, int]:
    """A rank's part of the window [first, V) of a vocabulary split over
    tensor (each rank holding `rows` rows; a whole table on every rank
    without `tp`) -> (lo, offset): its held rows lo.. are the window's
    entries offset.. (lo == rows: it holds none of the window)."""
    start = 0 if tp is None else tp.index * rows
    lo = min(max(first - start, 0), rows)
    return lo, start + lo - first


_LOW = 0xFFFFFFFF  # the packed argmax's low 32 bits: the complemented index


def vocab_argmax(logits: torch.Tensor, tp: TensorParallel | None, offset: int | None = None) -> torch.Tensor:
    """The index of the first maximum of logits [..., V] split over tensor,
    as argmax over the whole: this rank's columns are entries offset.. of
    the whole (a rank may hold none: [..., 0]); offset None: the columns
    split in equal slices in rank order (a table's or a head's split). Without
    `tp` the logits are whole on every rank: argmax + offset. Over tensor each rank packs its
    first maximum into an int64, the fp32 value mapped to an order-preserving
    int32 (-0.0 as +0.0, as argmax compares them) above the complemented
    global index, and one MAX all-reduce over tensor gives the largest value
    at the smallest index; a rank without a column contributes the least
    int64 (as -inf). -> int64 [...]."""
    if offset is None:
        offset = 0 if tp is None else tp.index * logits.shape[-1]
    if tp is None:
        return logits.argmax(dim=-1) + offset
    if logits.shape[-1] == 0:
        packed = torch.full(logits.shape[:-1], torch.iinfo(torch.int64).min, dtype=torch.int64, device=logits.device)
    else:
        index = logits.argmax(dim=-1, keepdim=True)
        value = logits.gather(-1, index)[..., 0].to(torch.float32)
        value = torch.where(value == 0, value.new_zeros(()), value)
        bits = value.view(torch.int32)
        key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
        packed = (key << 32) | (_LOW - (index[..., 0] + offset))
    collectives.tensor_all_reduce_max(packed, tp.group)
    return _LOW - (packed & _LOW)


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """Megatron's _VocabParallelCrossEntropy over this rank's fp32 logit
    columns start.. of the vocabulary: the row maximum by one MAX all-reduce
    (no gradient through it), then Σexp(logit - max) and the target's logit
    (on the rank that holds the target, 0 elsewhere) summed over tensor in
    one all-reduce; nll = -((target logit - max) - log Σ), as log_softmax's
    order. The backward: softmax - one-hot on the rank's columns, times the
    incoming gradient."""

    @staticmethod
    def forward(ctx, logits, targets, start, vocab, group):
        n = logits.shape[-1]
        x = logits
        if start + n > vocab:  # the rows of a table padded past the vocabulary count as -inf
            x = logits.masked_fill(torch.arange(start, start + n, device=logits.device) >= vocab, float("-inf"))
        m = collectives.tensor_all_reduce_max(x.amax(dim=-1), group)
        e = torch.exp(x - m[..., None])
        local = targets - start
        mine = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        picked = x.gather(-1, local[..., None])[..., 0]
        sums = torch.stack([e.sum(dim=-1), torch.where(mine, picked, picked.new_zeros(()))])
        collectives.tensor_all_reduce(sums, group)
        nll = -((sums[1] - m) - torch.log(sums[0]))
        ctx.save_for_backward(e.div_(sums[0][..., None]), local, mine)
        return nll

    @staticmethod
    def backward(ctx, grad):
        softmax, local, mine = ctx.saved_tensors
        g = softmax.scatter_add(-1, local[..., None], -mine.to(softmax.dtype)[..., None])
        return g * grad[..., None], None, None, None, None


def vocab_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, tp: TensorParallel | None,
                        vocab: int) -> torch.Tensor:
    """-log softmax(logits)[target] per row, fp32 [...], of fp32 logits
    [..., n] over a vocabulary of `vocab` entries split over tensor (this
    rank's columns: entries index * n.., those past `vocab` counted as
    -inf) against int64 targets [...] of the whole vocabulary. Without `tp`
    the logits are whole: log_softmax and the target's entry, one card's
    arithmetic."""
    if tp is None:
        return -torch.gather(F.log_softmax(logits, dim=-1), -1, targets[..., None])[..., 0]
    return _VocabParallelCrossEntropy.apply(logits, targets.long(), tp.index * logits.shape[-1], vocab, tp.group)


def whole_groups(q: torch.Tensor, tp: TensorParallel | None, heads: int, kv: int) -> tuple[torch.Tensor, slice]:
    """A rank's query heads q [B, T, h_t, D], where they are fewer than a
    K/V head's group (heads // kv), placed at their places among the
    group's other heads as zeros: the grouped attention's products then run
    at one card's shapes per K/V head, whose rows round as one card's (a
    library GEMM of fewer rows may take another kernel and round a row
    otherwise). -> (q, the slice of the rank's heads in the attention's
    output); q and slice(None) where its heads fill whole groups or without
    `tp`. The price: the group's work for the rank's share of it."""
    group, local = heads // kv, q.shape[2]
    if tp is None or local >= group:
        return q, slice(None)
    at = tp.index * local % group
    zeros = q.new_zeros((*q.shape[:2], group - local, q.shape[3]))
    return torch.cat([zeros[:, :, :at], q, zeros[:, :, at:]], dim=2), slice(at, at + local)


def kv_heads(tp: TensorParallel | None, heads: int, kv: int) -> slice:
    """The K/V heads (of all `kv`) that this rank's query heads read, where
    the query heads split over tensor and the K/V heads are held whole:
    grouped-query attention's query head h reads K/V head h // (heads //
    kv), so a rank's heads [index * h_t, (index + 1) * h_t) read a run of
    them (one where h_t is below the group)."""
    if tp is None:
        return slice(0, kv)
    local, group = heads // tp.parts, heads // kv
    return slice(tp.index * local // group, -(-(tp.index + 1) * local // group))


# (a leaf replicated over tensor, the projection whose split makes its use partial), within one layer stack's
# attention: "blocks/attn" of a tower, "pairs/self/attn" or "pairs/cross/attn" of MVLA's expert
_PARTIAL = (
    # K/V kernels replicated over tensor (their heads do not split) beside split query heads
    (re.compile(r"(.*?/(?:blocks|pairs/self|pairs/cross)/attn)/[kv]/kernel(?:_q)?$"), "q"),
    # q/k/v biases, replicated by the rules and sliced with their columns at use
    (re.compile(r"(.*?/blocks/attn)/([qkv])/bias$"), None),
    # the connector's per-head q/k norms, applied to the rank's heads
    (re.compile(r"(.*?/blocks/attn)/([qk])_norm/scale$"), None),
)


def partial_paths(flat_params: dict) -> frozenset:
    """The leaves replicated over tensor whose gradient on a rank is its
    part only (summed over tensor by the optimizer): a layer stack's K/V
    kernels held whole beside its split q (a tower's blocks, MVLA's expert
    pairs), its q/k/v biases where their kernel is split, and the
    connector's per-head q/k norm scales where q/k split."""
    from intact_tpu_torch.parallel.sharding import Sharded

    def split(path: str) -> bool:
        leaf = flat_params.get(path)
        return isinstance(leaf, Sharded) and leaf.tensor is not None

    out = set()
    for path, leaf in flat_params.items():
        if isinstance(leaf, Sharded) and leaf.tensor is not None:
            continue
        for pattern, projection in _PARTIAL:
            m = pattern.match(path)
            if m is not None and any(split(f"{m.group(1)}/{projection or m.group(2)}/{k}")
                                     for k in ("kernel", "kernel_q")):
                out.add(path)
    return frozenset(out)
