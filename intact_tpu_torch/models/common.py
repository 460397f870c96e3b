"""Functional layer library: dense / norm / embed / MLP + init helpers.

Parameters are nested dicts of tensors laid out as in the reference: dense
kernels [in, out], per-layer block weights stacked [L, ...]. The dtype
policy keeps parameters in `param_dtype` and computes in `compute_dtype`;
norm statistics are taken in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

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

class Initializer:
    """Random parameter factory on one device from an explicit seeded generator.

    On the "meta" device it makes shapes only (no generator, no memory); the
    weight bridge uses that as the template of the parameter tree."""

    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.generator = None
        if self.device.type != "meta":
            self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, shape, std: float) -> torch.Tensor:
        x = torch.randn(tuple(shape), generator=self.generator, device=self.device, dtype=self.dtype)
        return x.mul_(std)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(tuple(shape), device=self.device, dtype=self.dtype)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(tuple(shape), device=self.device, dtype=self.dtype)


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

def dense(p: Params, x: torch.Tensor, policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    y = policy.cast(x) @ p["kernel"].to(policy.compute_dtype)
    if "bias" in p:
        y = y + p["bias"].to(policy.compute_dtype)
    return y


def embed_lookup(p: Params, ids: torch.Tensor, policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    # out-of-range ids clip to the table (never index past it)
    table = p["embedding"]
    return table[ids.long().clamp(0, table.shape[0] - 1)].to(policy.compute_dtype)


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


def gelu_mlp(p: Params, x: torch.Tensor, policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """ViT MLP: dense -> gelu(tanh) -> dense."""
    h = F.gelu(dense(p["fc1"], x, policy), approximate="tanh")
    return dense(p["fc2"], h, policy)


def gemma_mlp(p: Params, x: torch.Tensor, policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Gemma gated MLP: gelu(gate(x)) * up(x) -> down."""
    gate = F.gelu(dense(p["gate"], x, policy), approximate="tanh")
    up = dense(p["up"], x, policy)
    return dense(p["down"], gate * up, policy)


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


def layer(blocks: Params, i: int) -> Params:
    """Layer i of a stacked [L, ...] block tree (views, no copy)."""
    return tree_map(lambda a: a[i], blocks)
