"""SigLIP vision tower (So400m/14-224 by default) — PaliGemma's image encoder.

`init(cfg, ...)` builds a stacked-block param tree, `encode(params, images,
cfg)` maps [-1, 1] images [B, H, W, 3] to patch tokens [B, N, width]. The
classification head is omitted: PaliGemma consumes the post-norm patch
embeddings. Attention (head_dim 72) stays on the plain path. Under autograd
with the blocks split over fsdp ranks (`Sharded`, ZeRO-3), each layer runs
under `torch.utils.checkpoint`, so no gathered layer outlives its forward
(the reference remats it per layer); whole blocks keep their activations.

Over tensor ranks (Megatron-style, parallel/tensor.py): where the heads split,
q, k and v are column-parallel (this rank's heads; their biases, which the
rules keep whole, sliced with their columns), o row-parallel with its bias
added once after the all-reduce; fc1 column- and fc2 row-parallel likewise
(`cm.gelu_mlp`). The patch embed stays whole on every tensor rank (the rules'
tensor axis on it is dropped: the blocks take the whole embedded image on
every rank). The tower finds its tensor group in its parameters.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models.common import DEFAULT_POLICY, DtypePolicy
from intact_tpu_torch.ops.attention import multi_head_attention
from intact_tpu_torch.parallel import tensor as tensor_parallel
from intact_tpu_torch.parallel.sharding import Sharded


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1152
    depth: int = 27
    mlp_dim: int = 4304
    num_heads: int = 16
    layernorm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads


def so400m_14_224() -> SigLIPConfig:
    return SigLIPConfig()


def tiny_test_config() -> SigLIPConfig:
    """Small config for CPU unit tests."""
    return SigLIPConfig(image_size=28, patch_size=14, width=32, depth=2, mlp_dim=64, num_heads=4)


def init_params(init: cm.Initializer, cfg: SigLIPConfig) -> cm.Params:
    p, d, m, lead = cfg.patch_size, cfg.width, cfg.mlp_dim, (cfg.depth,)
    return {
        "patch_embed": {
            "kernel": cm.lecun_normal(init, (p, p, 3, d), p * p * 3),
            "bias": init.zeros((d,)),
        },
        "pos_embed": init.normal((1, cfg.num_patches, d), 0.02),
        "blocks": {
            "ln1": cm.layernorm_init(init, d, lead),
            "attn": {name: cm.dense_init(init, d, d, lead=lead) for name in ("q", "k", "v", "o")},
            "ln2": cm.layernorm_init(init, d, lead),
            "mlp": {
                "fc1": cm.dense_init(init, d, m, lead=lead),
                "fc2": cm.dense_init(init, m, d, lead=lead),
            },
        },
        "ln_post": cm.layernorm_init(init, d),
    }


def init(cfg: SigLIPConfig, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    return init_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


def _block_apply(cfg: SigLIPConfig, policy: DtypePolicy, x: torch.Tensor, bp: cm.Params,
                 tp: tensor_parallel.TensorParallel | None = None) -> torch.Tensor:
    b, n, d = x.shape
    hd = cfg.head_dim

    y = cm.layer_norm(bp["ln1"], x, cfg.layernorm_eps)
    attn = bp["attn"]
    tpa = tensor_parallel.region(tp, attn["q"], d)
    y = tensor_parallel.copy_in(y, tpa)
    q, k, v = (cm.dense_column(attn[name], y, policy, tpa).reshape(b, n, -1, hd) for name in ("q", "k", "v"))
    att = multi_head_attention(q, k, v, mask=None)  # full bidirectional
    x = x + cm.dense_row(attn["o"], att.reshape(b, n, -1), policy, tpa)

    y = cm.layer_norm(bp["ln2"], x, cfg.layernorm_eps)
    mlp = bp["mlp"]
    return x + cm.gelu_mlp(mlp, y, policy, tensor_parallel.region(tp, mlp["fc1"], cfg.mlp_dim))


def encode(
    params: cm.Params,
    images: torch.Tensor,  # [B, H, W, 3] in [-1, 1]
    cfg: SigLIPConfig,
    policy: DtypePolicy = DEFAULT_POLICY,
) -> torch.Tensor:
    """-> [B, num_patches, width] patch embeddings (compute dtype)."""
    # patchify as reshape + one matmul (a stride-P VALID conv): patches are
    # (row, col)-ordered, each flattened (py, px, channel) against the
    # kernel [P, P, 3, D] flattened the same way
    b, g, p = images.shape[0], cfg.grid, cfg.patch_size
    x = policy.cast(images).reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, cfg.num_patches, p * p * 3)
    kernel = policy.cast(cm.whole(params["patch_embed"]["kernel"]))
    x = x @ kernel.reshape(p * p * 3, cfg.width) + policy.cast(params["patch_embed"]["bias"])
    x = x + policy.cast(params["pos_embed"])

    blocks = params["blocks"]
    tp = tensor_parallel.of(blocks)
    remat = torch.is_grad_enabled() and any(isinstance(w, Sharded) and w.fsdp_split for w in cm.tree_leaves(blocks))
    for i in range(cfg.depth):
        if remat:  # the layer gathered inside the checkpoint, again in the recompute
            x = checkpoint(lambda x, i: _block_apply(cfg, policy, x, cm.layer(blocks, i), tp), x, i,
                           use_reentrant=False)
        else:
            x = _block_apply(cfg, policy, x, cm.layer(blocks, i), tp)
    return cm.layer_norm(params["ln_post"], x, cfg.layernorm_eps)
