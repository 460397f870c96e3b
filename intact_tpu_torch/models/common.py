"""Functional layer library: dense / norm / embed / MLP + init helpers, and
the int8 (W8A8) serving form of the dense layers.

Parameters are nested dicts of tensors laid out as in the reference: dense
kernels [in, out], per-layer block weights stacked [L, ...]. The dtype
policy keeps parameters in `param_dtype` and computes in `compute_dtype`;
norm statistics are taken in fp32. A quantized dense node holds int8
`kernel_q` [..., out, in] (K-major: the transpose of the reference's
[..., in, out] codes, the layout the W8A8 kernel's wgmma reads) and fp32
`kernel_scale` [..., out] (per output channel, per layer when stacked);
`dense` sends it through the W8A8 kernel.

Over fsdp ranks (`parallel/sharding.py`: serving, and ZeRO-3 training), a
leaf the rules split is a `Sharded` holder of this rank's slice; only
`layer` (a stacked tree's layer), `dense`, `embed_lookup`, `unembed_logits`
and `whole` gather it, each through one layer bucket (one all-gather for all
the split leaves it needs; where a leaf trains, the backward reduce-scatters
its gradient the same way: `sharding.GatherLayer`).

Over tensor ranks (Megatron-style, parallel/tensor.py) a split product holds
this rank's columns or rows: `dense_column` multiplies by its output columns
(slicing a whole bias to them), `dense_row` by its input rows, all-reduces
the fp32 partials over tensor and then adds the bias and casts, as one card
rounds the whole product. An int8 row-parallel product stays bit-equal to one
card's: the activation rows are quantized against the whole row's absmax (a
MAX all-reduce over tensor), the exact int32 partials are summed over tensor,
and the finish pass rescales them (`ops/w8a8.py`'s row-parallel entry).
`embed_lookup` looks up a vocabulary-parallel table (float or int8) and
`unembed_logits` gives a rank's logit columns of one
(`tensor_parallel.vocab_argmax` takes the greedy token over all of them).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Callable

import torch
import torch.nn.functional as F

from intact_tpu_torch.parallel import tensor as tensor_parallel
from intact_tpu_torch.parallel.sharding import Sharded, gather_tree

Params = dict  # nested dict of tensors


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


DEFAULT_POLICY = DtypePolicy()
SERVING_POLICY = DtypePolicy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
FP32_POLICY = DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Without a CUDA device and without an explicit device this raises; it
    never falls back to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

_ON_HOST = False  # set inside `made_on_host`


@contextlib.contextmanager
def made_on_host():
    """Initializers made inside draw on their device, from its generator,
    and move each leaf to the host as it is made: the values of an init on
    the device, which holds one leaf at a time (a rank then keeps its
    share: parallel.sharding.shard_tree)."""
    global _ON_HOST
    before, _ON_HOST = _ON_HOST, True
    try:
        yield
    finally:
        _ON_HOST = before


class Initializer:
    """Random parameter factory on one device from an explicit seeded generator.

    On the "meta" device it makes shapes only (no generator, no memory); the
    weight bridge uses that as the template of the parameter tree. Made
    inside `made_on_host`, it hands its leaves over to the host."""

    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.store = torch.device("cpu") if _ON_HOST and self.device.type != "meta" else self.device
        self.generator = None
        if self.device.type != "meta":
            self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, shape, std: float) -> torch.Tensor:
        x = torch.randn(tuple(shape), generator=self.generator, device=self.device, dtype=self.dtype)
        return x.mul_(std).to(self.store)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(tuple(shape), device=self.store, dtype=self.dtype)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(tuple(shape), device=self.store, dtype=self.dtype)


def lecun_normal(init: Initializer, shape, fan_in: int) -> torch.Tensor:
    return init.normal(shape, math.sqrt(1.0 / fan_in))


def dense_init(init: Initializer, in_dim: int, out_dim: int, use_bias: bool = True,
               lead: tuple = ()) -> Params:
    """`lead` prepends stacked-layer axes: kernel [*lead, in, out]."""
    p = {"kernel": lecun_normal(init, (*lead, in_dim, out_dim), in_dim)}
    if use_bias:
        p["bias"] = init.zeros((*lead, out_dim))
    return p


def embed_init(init: Initializer, vocab: int, dim: int) -> Params:
    return {"embedding": init.normal((vocab, dim), 0.02)}


def rmsnorm_init(init: Initializer, dim: int, lead: tuple = ()) -> Params:
    # Gemma convention: weight stored as (scale), applied as x * (1 + scale)
    return {"scale": init.zeros((*lead, dim))}


def layernorm_init(init: Initializer, dim: int, lead: tuple = ()) -> Params:
    return {"scale": init.ones((*lead, dim)), "bias": init.zeros((*lead, dim))}


# ---------------------------------------------------------------------------
# apply functions
# ---------------------------------------------------------------------------

def whole(x, index=None):
    """A leaf whole (`x[index]` with an index before its split dimension):
    a `Sharded` leaf gathered over its fsdp group (a bucket of one leaf, with
    its gradient where it trains), a tensor as it is."""
    if isinstance(x, Sharded):
        return gather_tree({"x": x}, index)["x"]
    return x if index is None else x[index]


def _whole_node(p: Params) -> Params:
    if any(isinstance(v, Sharded) for v in p.values()):
        return gather_tree(p)
    return p


def dense(p: Params, x: torch.Tensor, policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    p = _whole_node(p)
    if "kernel_q" in p:
        return _dense_int8(p, x, policy)
    y = policy.cast(x) @ p["kernel"].to(policy.compute_dtype)
    if "bias" in p:
        y = y + p["bias"].to(policy.compute_dtype)
    return y


def dense_column(p: Params, x: torch.Tensor, policy: DtypePolicy = DEFAULT_POLICY,
                 tp: tensor_parallel.TensorParallel | None = None) -> torch.Tensor:
    """A column-parallel product: x (replicated: the region's input, through
    `tensor_parallel.copy_in` where a gradient flows) times this rank's output
    columns -> its columns of the output. A bias or an int8 node's per-channel
    `kernel_scale` held whole (the rules replicate them) is sliced to them.
    Without `tp`, `dense`."""
    p = _whole_node(p)
    if tp is not None:
        n = tensor_parallel.out_features(p)
        p = {k: v[..., tp.columns(n)] if k in ("bias", "kernel_scale") and v.shape[-1] != n else v
             for k, v in p.items()}
    return dense(p, x, policy)


def _fp32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w accumulated and returned in fp32 (bf16 operands: fp32 sums of
    their exact products)."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda and not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32).reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def dense_row(p: Params, x: torch.Tensor, policy: DtypePolicy = DEFAULT_POLICY,
              tp: tensor_parallel.TensorParallel | None = None) -> torch.Tensor:
    """A row-parallel product: x (this rank's columns of the region, e.g. its
    heads' attention) times this rank's input rows; the fp32 partials summed
    over tensor (`tensor_parallel.reduce_out`), then the whole bias added
    and the result cast, in one card's order. int8: `_dense_int8_row`.
    Without `tp`, `dense`."""
    p = _whole_node(p)
    if tp is None:
        return dense(p, x, policy)
    if "kernel_q" in p:
        return _dense_int8_row(p, x, policy, tp)
    y = tensor_parallel.reduce_out(_fp32_product(policy.cast(x), p["kernel"].to(policy.compute_dtype)), tp)
    y = y.to(policy.compute_dtype)
    if "bias" in p:
        y = y + p["bias"].to(policy.compute_dtype)
    return y


def _dense_int8_row(p: Params, x: torch.Tensor, policy: DtypePolicy,
                    tp: tensor_parallel.TensorParallel) -> torch.Tensor:
    """The row-parallel W8A8 product, bit-equal to `_dense_int8` on the whole
    row: each activation row's absmax over this rank's K slice, its max over
    tensor (one MAX all-reduce), this rank's exact int32 partial product with
    its rows of the codes quantized against that whole-row scale
    (`w8a8_partial`), the partials summed over tensor (one int32 all-reduce),
    and the finish pass: acc = fma(float(sum), xs, 0), then * wscale or
    fma(acc, wscale, bias), cast (`w8a8_finish`). No gradient, as `_dense_int8`."""
    from intact_tpu_torch.ops.w8a8 import row_absmax, w8a8_finish, w8a8_partial
    from intact_tpu_torch.parallel import collectives

    if p["kernel_q"].ndim != 2:
        raise ValueError(f"_dense_int8_row takes one layer's kernel [out, in]; got {tuple(p['kernel_q'].shape)}")
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    amax = collectives.tensor_all_reduce_max(row_absmax(x2), tp.group)
    part, xs = w8a8_partial(x2, p["kernel_q"], amax, weight_layout="nk")
    collectives.tensor_all_reduce(part, tp.group)
    y = w8a8_finish(part, xs, p["kernel_scale"], p.get("bias"), out_dtype=policy.compute_dtype)
    return y.reshape(*lead, y.shape[-1])


def _dense_int8(p: Params, x: torch.Tensor, policy: DtypePolicy) -> torch.Tensor:
    """W8A8 dynamic-quant matmul with the reference's per-row semantics
    (activations quantized per row over the whole K, int32 product, fp32
    rescale by the activation and weight scales, fp32 bias), cast to the
    compute dtype. x is taken in its own dtype, as in the reference. On CUDA
    tensors this launches the W8A8 kernel (ops/w8a8.py) or raises; on CPU
    tensors it runs the kernel's plain version."""
    from intact_tpu_torch.ops.w8a8 import w8a8_matmul

    if p["kernel_q"].ndim != 2:
        raise ValueError(f"_dense_int8 takes one layer's kernel [out, in]; got {tuple(p['kernel_q'].shape)}")
    return w8a8_matmul(x, p["kernel_q"], p["kernel_scale"], p.get("bias"), out_dtype=policy.compute_dtype,
                       weight_layout="nk")


def embed_lookup(p: Params, ids: torch.Tensor, policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    # out-of-range ids clip to the table (never index past it)
    tp = tensor_parallel.of(p)
    if tp is not None:  # vocabulary-parallel: this rank's rows of the table (float, or int8 codes and scales)
        name = "embedding_q" if "embedding_q" in p else "embedding"
        vocab = p[name].whole_shape[0]
        p = _whole_node(p)
        rows = tensor_parallel.vocab_lookup(p[name], ids, vocab, tp, p.get("embed_scale"))
        return rows.to(policy.compute_dtype)
    p = _whole_node(p)
    if "embedding_q" in p:  # int8 rows + per-row scale (quantize_embed)
        idx = ids.long().clamp(0, p["embedding_q"].shape[0] - 1)
        rows = p["embedding_q"][idx].to(torch.float32)
        return (rows * p["embed_scale"][idx].to(torch.float32)[..., None]).to(policy.compute_dtype)
    table = p["embedding"]
    return table[ids.long().clamp(0, table.shape[0] - 1)].to(policy.compute_dtype)


def unembed_logits(p: Params, hidden: torch.Tensor, policy: DtypePolicy | None = None) -> torch.Tensor:
    """Tied unembedding: hidden [..., D] x embed [V, D]^T -> fp32 [..., V];
    of a vocabulary-parallel table, this rank's columns [..., V / t] (its
    rows of the table; `tensor_parallel.vocab_argmax` reduces them).

    A quantized table (`quantize_embed`: int8 rows [V, D], already the
    K-major [N, K] codes the W8A8 kernel reads, and fp32 per-row scales)
    goes through `w8a8_matmul` with the per-row semantics: the reference's
    (float(int32 sum) * x_scale) * embed_scale, x_scale = max(amax, 1e-6) *
    fl(1/127). On CUDA tensors that launches the W8A8 kernel (or raises); on
    CPU tensors it runs the kernel's plain version."""
    policy = policy or DEFAULT_POLICY
    p = _whole_node(p)
    if "embedding_q" not in p:
        emb = p["embedding"].to(policy.compute_dtype)
        return (hidden.to(policy.compute_dtype) @ emb.T).to(torch.float32)
    from intact_tpu_torch.ops.w8a8 import w8a8_matmul

    return w8a8_matmul(hidden, p["embedding_q"], p["embed_scale"], out_dtype=torch.float32, weight_layout="nk")


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma RMSNorm: fp32 statistics, (1 + scale) gain, cast back."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    y = y * (1.0 + p["scale"].to(torch.float32))
    return y.to(x.dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def gelu_mlp(p: Params, x: torch.Tensor, policy: DtypePolicy = DEFAULT_POLICY,
             tp: tensor_parallel.TensorParallel | None = None) -> torch.Tensor:
    """ViT MLP: dense -> gelu(tanh) -> dense; over tensor (`tp`: the
    region's group, `tensor_parallel.region`) fc1 column- and fc2
    row-parallel."""
    h = F.gelu(dense_column(p["fc1"], tensor_parallel.copy_in(x, tp), policy, tp), approximate="tanh")
    return dense_row(p["fc2"], h, policy, tp)


def gemma_mlp(p: Params, x: torch.Tensor, policy: DtypePolicy = DEFAULT_POLICY,
              tp: tensor_parallel.TensorParallel | None = None) -> torch.Tensor:
    """Gemma gated MLP: gelu(gate(x)) * up(x) -> down; over tensor (`tp`)
    gate and up column- and down row-parallel."""
    x = tensor_parallel.copy_in(x, tp)
    gate = F.gelu(dense_column(p["gate"], x, policy, tp), approximate="tanh")
    up = dense_column(p["up"], x, policy, tp)
    return dense_row(p["down"], gate * up, policy, tp)


def attention_qkv(p: Params, y: torch.Tensor, positions: torch.Tensor, heads: int, kv: int, head_dim: int,
                  rope_base: float, policy: DtypePolicy = DEFAULT_POLICY,
                  tp: tensor_parallel.TensorParallel | None = None):
    """q and k (roped) and v [B, T, *, head_dim] of a grouped-query layer's
    projections p (q, k, v) on its normed input y: over tensor (`tp`, where
    the rules split the query heads) q column-parallel, k and v too where
    their heads split, else whole with only the K/V heads this rank's
    queries read kept (`tensor_parallel.kv_heads`)."""
    from intact_tpu_torch.ops.rope import apply_rope

    b, t, _ = y.shape
    tpa = tensor_parallel.region(tp, p["q"], heads * head_dim)
    y = tensor_parallel.copy_in(y, tpa)
    tkv = tensor_parallel.region(tpa, p["k"], kv * head_dim)
    q = dense_column(p["q"], y, policy, tpa).reshape(b, t, -1, head_dim)
    k = dense_column(p["k"], y, policy, tkv).reshape(b, t, -1, head_dim)
    v = dense_column(p["v"], y, policy, tkv).reshape(b, t, -1, head_dim)
    if tpa is not None and tkv is None:
        used = tensor_parallel.kv_heads(tpa, heads, kv)
        k, v = k[:, :, used], v[:, :, used]
    return apply_rope(q, positions, rope_base), apply_rope(k, positions, rope_base), v


def new_kv_cache(depth: int, k: torch.Tensor, slots: int, policy: DtypePolicy) -> tuple[torch.Tensor, torch.Tensor]:
    """An empty (k, v) cache [depth, B, slots, heads, head_dim] for keys
    shaped as k [B, T, heads, head_dim] (a rank's K/V heads over tensor), in
    the compute dtype; the slots past T zero."""
    b, t, h, d = k.shape
    cache_k = torch.empty((depth, b, slots, h, d), dtype=policy.compute_dtype, device=k.device)
    cache_v = torch.empty_like(cache_k)
    if slots > t:
        cache_k[:, :, t:].zero_()
        cache_v[:, :, t:].zero_()
    return cache_k, cache_v


def sinusoidal_embedding(time: torch.Tensor, dim: int, min_period: float,
                         max_period: float) -> torch.Tensor:
    """Scalar positions [B] -> [B, dim] sine-cosine features (fp32), with
    geometric period spacing from min_period to max_period."""
    if dim % 2 != 0:
        raise ValueError(f"dimension ({dim}) must be divisible by 2")
    fraction = torch.linspace(0.0, 1.0, dim // 2, dtype=torch.float32, device=time.device)
    period = min_period * (max_period / min_period) ** fraction
    angle = (2 * math.pi / period)[None, :] * time.to(torch.float32)[:, None]
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# tree helpers
# ---------------------------------------------------------------------------

def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def flatten_paths(tree, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_paths(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def unflatten_paths(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested dict."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def layer(blocks: Params, i: int) -> Params:
    """Layer i of a stacked [L, ...] block tree: views, no copy, of whole
    leaves; the `Sharded` leaves' layer gathered over their fsdp group in one
    bucket (`sharding.gather_tree`)."""
    return gather_tree(blocks, i)


def gathered(tree: Params) -> Params:
    """A tree with its `Sharded` leaves whole over fsdp, through one bucket
    (a tree used several times in one pass: gathered once, its gradient
    summed by autograd before the one reduce-scatter); a leaf split over
    tensor stays this rank's tensor slice, held by a `Sharded` of no fsdp
    group, so its users still find the tensor group (`tensor_parallel.of`)."""
    out = gather_tree(tree)

    def keep(node, whole):
        if isinstance(node, dict):
            return {k: keep(v, whole[k]) for k, v in node.items()}
        if isinstance(node, Sharded) and node.tensor is not None:
            return Sharded(whole, 0, tuple(whole.shape), None, 1, tensor=node.tensor)
        return whole

    return keep(tree, out)


# ---------------------------------------------------------------------------
# int8 serving form
# ---------------------------------------------------------------------------

# the default int8 coverage: every kernel under a "blocks" subtree (and the
# mvla expert's self/cross pair stacks) plus the multimodal projector and an
# AR unembedding (`lm_head`); norms stay fp
QUANTIZE_DEFAULT_PATTERN = (
    r".*((blocks|pairs/(self|cross))/(attn|mlp)/[a-z0-9_]+|img_proj|lm_head)$"
)

# AR-family tied embeddings ("lm/embed"), quantized to int8 rows; pi0's
# vlm_embed stays fp
UNEMBED_QUANT_PATTERN = r".*lm/embed$"


def _absmax_quantize(w: torch.Tensor, dim: int, floor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """round(w / s) as int8 with s = max(max|w| over `dim` * fl(1/127),
    floor), in fp32, keeping `dim` as size 1 in s. The reference's `/ 127.0`
    runs compiled (jax.jit(quantize_params)), where XLA multiplies by the
    reciprocal instead."""
    from intact_tpu_torch.ops.w8a8 import INV127

    w = w.to(torch.float32)
    scale = w.abs().amax(dim=dim, keepdim=True)  # NaN propagates, as in jnp.max
    scale = torch.maximum(scale * torch.full_like(scale, INV127), torch.full_like(scale, floor))
    return torch.round(w / scale).to(torch.int8), scale


def quantize_dense(p: Params) -> Params:
    """fp kernel [..., in, out] -> int8 `kernel_q` [..., out, in] (K-major)
    + fp32 per-output-channel `kernel_scale` [..., out] (stacked layers keep
    per-(layer, out) scales). The codes are the reference's, transposed once
    here. Stacked kernels are quantized one layer at a time, so the fp32
    temporaries hold one layer."""
    kernel = p["kernel"]
    lead, (din, dout) = kernel.shape[:-2], kernel.shape[-2:]
    flat = kernel.reshape(-1, din, dout)
    kq = torch.empty((flat.shape[0], dout, din), dtype=torch.int8, device=kernel.device)
    scale = torch.empty((flat.shape[0], dout), dtype=torch.float32, device=kernel.device)
    for i in range(flat.shape[0]):
        q, s = _absmax_quantize(flat[i], dim=-2, floor=1e-12)
        kq[i], scale[i] = q.T, s[0]
    out = {"kernel_q": kq.reshape(*lead, dout, din), "kernel_scale": scale.reshape(*lead, dout)}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quantize_embed(p: Params) -> Params:
    """Embedding table [V, D] -> int8 rows `embedding_q` + fp32 per-row
    `embed_scale` [V]."""
    q, s = _absmax_quantize(p["embedding"], dim=-1, floor=1e-12)
    return {"embedding_q": q, "embed_scale": s[:, 0]}


def quantize_params(params: Params, consume: bool = False) -> Params:
    """Quantize the FLOP-heavy kernels (transformer block matmuls, the
    projector; QUANTIZE_DEFAULT_PATTERN) and tied AR embeddings
    (UNEMBED_QUANT_PATTERN) to int8, leaf by leaf.

    consume=True empties `params` as it goes, so each fp node is released
    once its int8 form exists: the whole fp tree and the whole int8 tree
    never coexist. Other leaves move into the result as they are.
    """
    default = re.compile(QUANTIZE_DEFAULT_PATTERN)
    embed_re = re.compile(UNEMBED_QUANT_PATTERN)

    def walk(node, path=""):
        if not isinstance(node, dict):
            return node
        if "kernel" in node and default.match(path):
            return quantize_dense(node)
        if "embedding" in node and embed_re.match(path):
            return quantize_embed(node)
        out = {}
        for k in list(node):
            out[k] = walk(node[k], f"{path}/{k}" if path else k)
            if consume:
                del node[k]
        return out

    return walk(params)


def quantize_frozen(params: Params, trainable_mask) -> Params:
    """Quantize the dense nodes that match QUANTIZE_DEFAULT_PATTERN and are
    wholly frozen (every leaf False in `trainable_mask`, a bool tree like
    params) to int8 with `quantize_dense`; trainable kernels stay float and
    every other leaf moves into the result as it is. The trainer's
    quantize_frozen_int8 mode: the frozen tower's forward goes through the
    W8A8 kernel while the expert keeps float masters."""
    default = re.compile(QUANTIZE_DEFAULT_PATTERN)

    def walk(node, mask_node, path=""):
        if not isinstance(node, dict):
            return node
        if "kernel" in node and default.match(path):
            return node if any(tree_leaves(mask_node)) else quantize_dense(node)
        return {k: walk(v, mask_node[k], f"{path}/{k}" if path else k) for k, v in node.items()}

    return walk(params, trainable_mask)


def quantize_host_tree(raw: Params, policy: DtypePolicy = SERVING_POLICY, device=None, place=None) -> Params:
    """A host (CPU tensor or numpy) parameter tree -> the serving-int8 tree on
    `device` (CUDA unless given), one leaf at a time: the device holds the
    int8 tree and one fp leaf at most. Quantized kernels are cast to the
    compute dtype first, biases and other leaves to the param dtype, as in
    the reference's checkpoint-load path. `place(path, leaf)` takes each
    finished leaf on the device (a rank keeps its share: `shard_leaf`)."""
    import numpy as np

    device = resolve_device(device)
    default = re.compile(QUANTIZE_DEFAULT_PATTERN)
    embed_re = re.compile(UNEMBED_QUANT_PATTERN)

    def put(leaf, dtype):
        t = torch.from_numpy(np.asarray(leaf)) if not isinstance(leaf, torch.Tensor) else leaf
        return t.to(device=device, dtype=dtype)

    def finish(node: Params, path: str) -> Params:
        return node if place is None else {k: place(f"{path}/{k}", v) for k, v in node.items()}

    def walk(node, path=""):
        if not isinstance(node, dict):
            leaf = put(node, policy.param_dtype)
            return leaf if place is None else place(path, leaf)
        if "kernel" in node and default.match(path):
            out = quantize_dense({"kernel": put(node["kernel"], policy.compute_dtype)})
            if "bias" in node:
                out["bias"] = put(node["bias"], policy.param_dtype)
            return finish(out, path)
        if "embedding" in node and embed_re.match(path):
            return finish(quantize_embed({"embedding": put(node["embedding"], policy.compute_dtype)}), path)
        return {k: walk(v, f"{path}/{k}" if path else k) for k, v in node.items()}

    return walk(raw)
