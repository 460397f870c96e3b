"""Weight bridge: the reference's parameter tree of a ported model (as numpy) -> the port's tensors.

Both packages lay their parameters out the same way (nested dicts, dense
kernels [in, out], per-layer weights stacked [L, ...] under "blocks"), so the
bridge is a checked walk: every reference leaf must land on a port parameter
of the same path and shape, and every port parameter must be filled.
Leftovers on either side raise.

A quantized reference tree (`quantize_params` of the JAX package) carries
across the same way against the port's `quantize_params` of the meta-device
template: int8 `kernel_q` bit for bit, transposed from the reference's
[..., in, out] to the port's K-major [..., out, in]; fp32 `kernel_scale` as
fp32. A quantized tied table (`quantize_embed`: int8 `embedding_q` [V, D]
rows, fp32 `embed_scale` [V]) carries across as it is: its rows are already
the K-major codes the port's W8A8 kernel reads.

`from_jax_fused_state` carries a fused training state across the same way:
parameters as above, fp8 moment codes bit for bit (numpy's uint8 view of the
ml_dtypes array -> torch's float8 view), scales and exact moments as fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models import registry
from intact_tpu_torch.models.pi0.config import Pi0Config


def from_jax_params(tree, cfg, device=None, dtype=torch.float32) -> cm.Params:
    """Map the reference `init` tree of the model `cfg` configures (any
    registered config class; leaves as numpy arrays), or a form with
    quantized dense nodes and tied tables (`quantize_params`,
    `quantize_frozen`), onto the port's parameter tree for `cfg`, on
    `device` (CUDA unless given), float leaves in `dtype`; int8 codes stay
    int8 and quantization scales fp32."""
    device = cm.resolve_device(device)
    src = cm.flatten_paths(tree)
    quantized = {path[:-len("/kernel_q")] for path in src if path.endswith("/kernel_q")}
    quantized_tables = {path[:-len("/embedding_q")] for path in src if path.endswith("/embedding_q")}

    def quantize_like_src(node, path=""):
        if not isinstance(node, dict):
            return node
        if "kernel" in node and path in quantized:
            return cm.quantize_dense(node)
        if "embedding" in node and path in quantized_tables:
            return cm.quantize_embed(node)
        return {k: quantize_like_src(v, f"{path}/{k}" if path else k) for k, v in node.items()}

    template = quantize_like_src(registry.module_for_config(cfg).init(cfg, device="meta", dtype=dtype))
    want = cm.flatten_paths(template)
    missing = sorted(set(want) - set(src))
    extra = sorted(set(src) - set(want))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, unconsumed {extra}")

    def fill(node, prefix=""):
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}/{k}" if prefix else k) for k, v in node.items()}
        leaf = np.asarray(src[prefix])
        if prefix.endswith("/kernel_q"):  # [..., in, out] -> the port's K-major [..., out, in]
            leaf = np.swapaxes(leaf, -1, -2)
        if tuple(leaf.shape) != tuple(node.shape):
            raise ValueError(f"{prefix}: reference shape {leaf.shape} != port shape {tuple(node.shape)}")
        if node.dtype == torch.int8:
            if leaf.dtype != np.int8:
                raise ValueError(f"{prefix}: int8 codes expected, got {leaf.dtype}")
            return torch.from_numpy(np.ascontiguousarray(leaf)).to(device)
        want = torch.float32 if prefix.endswith(("/kernel_scale", "/embed_scale")) else dtype
        return torch.from_numpy(np.array(leaf, np.float32)).to(device=device, dtype=want)

    return fill(template)


_FP8_BY_NAME = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _moment_leaf(x, device) -> torch.Tensor:
    x = np.asarray(x)
    fp8 = _FP8_BY_NAME.get(x.dtype.name)
    if fp8 is not None:
        return torch.from_numpy(np.ascontiguousarray(x).view(np.uint8).copy()).view(fp8).to(device)
    if x.dtype != np.float32:
        raise ValueError(f"moment leaves are fp8 codes or fp32; got {x.dtype}")
    return torch.from_numpy(np.array(x)).to(device)


def from_jax_fused_state(state, cfg: Pi0Config, seed: int, device=None, block_size=2048, min_quant_elems=65536):
    """A JAX `fused_joint.FusedTrainState` (leaves as numpy or JAX arrays)
    -> the port's `FusedTrainState` on `device` (CUDA unless given).

    Parameters stay bf16 where every reference leaf is bf16 (the joint
    recipe's masters), else become fp32. The moment trees must match, leaf
    for leaf and in shape and dtype, the ones `init_fused_state(params, seed,
    block_size, min_quant_elems)` makes for `cfg`; leftovers on either side
    raise. The JAX generator key has no counterpart: the port's step draws
    from (seed, count)."""
    from intact_tpu_torch.train.fused_joint import init_fused_state

    device = cm.resolve_device(device)
    src = _numpy_tree(state.params)
    bf16 = all(x.dtype.name == "bfloat16" for x in cm.flatten_paths(src).values())
    params = from_jax_params(src, cfg, device, torch.bfloat16 if bf16 else torch.float32)
    fresh = init_fused_state(params, seed, block_size=block_size, min_quant_elems=min_quant_elems)
    for name in ("mu", "nu"):
        src = cm.flatten_paths(_numpy_tree(getattr(state, name)))
        want = cm.flatten_paths(getattr(fresh, name))
        missing, extra = sorted(set(want) - set(src)), sorted(set(src) - set(want))
        if missing or extra:
            raise ValueError(f"{name} trees differ: missing {missing}, unconsumed {extra}")
        for path, leaf in want.items():
            new = _moment_leaf(src[path], device)
            if new.shape != leaf.shape or new.dtype != leaf.dtype:
                raise ValueError(f"{name}/{path}: reference {tuple(new.shape)} {new.dtype} != "
                                 f"port {tuple(leaf.shape)} {leaf.dtype}")
            leaf.copy_(new)
    fresh.count = int(np.asarray(state.count))
    fresh.prev_gnorm = torch.tensor(float(np.asarray(state.prev_gnorm)), dtype=torch.float32, device=device)
    return fresh


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)
