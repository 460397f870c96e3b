"""ConvNeXt vision tower (Magma-8B's image encoder; intact_tpu/models/convnext.py).

Conventions, as in the reference (transformers ConvNextModel):
  * stem: 4x4/4 conv + channels-last LayerNorm;
  * block: 7x7 depthwise conv -> LN -> 4x pointwise -> exact GELU ->
    pointwise -> layer-scale gamma -> residual;
  * stage transitions: LN + 2x2/2 conv downsample;
  * pooled output: LN(global mean).

Activations are NHWC, as in the reference; the tree keeps its leaf layouts
(conv kernels HWIO, dense kernels [in, out], blocks stacked [L, ...] per
stage), and each conv permutes at the call: `F.conv2d` on the NCHW view of
the NHWC tensor (channels-last memory), groups=dim for the depthwise conv.
The convolutions and the pointwise products stay fp in int8 serving too
(`vision/stage_i/pw1` matches no quantization pattern): plain library
calls, as the reference leaves them to XLA.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models.common import DEFAULT_POLICY, DtypePolicy


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: tuple = (3, 3, 9, 3)
    dims: tuple = (96, 192, 384, 768)
    patch_size: int = 4
    kernel: int = 7
    norm_eps: float = 1e-6
    layer_scale_init: float = 1e-6


def convnext_tiny() -> ConvNeXtConfig:
    return ConvNeXtConfig()


def convnext_xxlarge() -> ConvNeXtConfig:
    """CLIP-ConvNeXt-XXLarge (the Magma-8B operating point)."""
    return ConvNeXtConfig(depths=(3, 4, 30, 3), dims=(384, 768, 1536, 3072))


def tiny_test_config() -> ConvNeXtConfig:
    return ConvNeXtConfig(depths=(2, 2), dims=(8, 16))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stage_init(init: cm.Initializer, depth: int, dim: int, cfg: ConvNeXtConfig) -> cm.Params:
    k, lead = cfg.kernel, (depth,)
    return {
        "dwconv": {"kernel": cm.lecun_normal(init, (depth, k, k, 1, dim), k * k), "bias": init.zeros((depth, dim))},
        "ln": cm.layernorm_init(init, dim, lead),
        "pw1": cm.dense_init(init, dim, 4 * dim, lead=lead),
        "pw2": cm.dense_init(init, 4 * dim, dim, lead=lead),
        "gamma": init.ones((depth, dim)).mul_(cfg.layer_scale_init),
    }


def init_params(init: cm.Initializer, cfg: ConvNeXtConfig, in_channels: int = 3) -> cm.Params:
    p = cfg.patch_size
    params: cm.Params = {
        "stem": {"kernel": cm.lecun_normal(init, (p, p, in_channels, cfg.dims[0]), p * p * in_channels),
                 "bias": init.zeros((cfg.dims[0],))},
        "stem_ln": cm.layernorm_init(init, cfg.dims[0]),
        "final_ln": cm.layernorm_init(init, cfg.dims[-1]),
    }
    for i, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        params[f"stage_{i}"] = _stage_init(init, depth, dim, cfg)
        if i > 0:
            prev = cfg.dims[i - 1]
            params[f"down_{i}"] = {
                "ln": cm.layernorm_init(init, prev),
                "conv": {"kernel": cm.lecun_normal(init, (2, 2, prev, dim), 4 * prev), "bias": init.zeros((dim,))},
            }
    return params


def init(cfg: ConvNeXtConfig, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    return init_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _conv(p: cm.Params, x: torch.Tensor, stride: int, policy: DtypePolicy, groups: int = 1,
          padding: int = 0) -> torch.Tensor:
    """NHWC x, HWIO kernel -> NHWC, then the bias added in the compute dtype
    (the reference's conv + bias)."""
    w = policy.cast(p["kernel"]).permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1) + policy.cast(p["bias"])


def _block_apply(cfg: ConvNeXtConfig, policy: DtypePolicy, x: torch.Tensor, bp: cm.Params) -> torch.Tensor:
    h = _conv(bp["dwconv"], x, 1, policy, groups=x.shape[-1], padding=cfg.kernel // 2)
    h = cm.layer_norm(bp["ln"], h, cfg.norm_eps)
    h = F.gelu(cm.dense(bp["pw1"], h, policy), approximate="none")
    h = cm.dense(bp["pw2"], h, policy)
    return x + policy.cast(bp["gamma"]) * h


def encode(params: cm.Params, images: torch.Tensor, cfg: ConvNeXtConfig,
           policy: DtypePolicy = DEFAULT_POLICY) -> tuple[torch.Tensor, torch.Tensor]:
    """images [B, H, W, 3] (preprocessed floats) -> (features [B, H', W',
    dims[-1]], pooled [B, dims[-1]]), in the compute dtype."""
    x = _conv(params["stem"], policy.cast(images), cfg.patch_size, policy)
    x = cm.layer_norm(params["stem_ln"], x, cfg.norm_eps)
    for i, depth in enumerate(cfg.depths):
        if i > 0:
            d = params[f"down_{i}"]
            x = _conv(d["conv"], cm.layer_norm(d["ln"], x, cfg.norm_eps), 2, policy)
        for j in range(depth):
            x = _block_apply(cfg, policy, x, cm.layer(params[f"stage_{i}"], j))
    pooled = cm.layer_norm(params["final_ln"], x.mean(dim=(1, 2)), cfg.norm_eps)
    return x, pooled


# ---------------------------------------------------------------------------
# HF checkpoint -> params
# ---------------------------------------------------------------------------

def from_hf_state_dict(sd: dict, cfg: ConvNeXtConfig, prefix: str = "convnext") -> cm.Params:
    """transformers ConvNextModel naming -> host parameter tree (CPU tensors):
    conv kernels [out, in, kh, kw] -> [kh, kw, in, out] (depthwise [dim, 1,
    k, k] -> [k, k, 1, dim]), Linear weights transposed, blocks stacked."""
    from intact_tpu_torch.models.hf_import import stack, t, tensor

    prefix = prefix + "." if prefix else ""

    def conv(x):
        return tensor(x).permute(2, 3, 1, 0).contiguous()

    def vec(name):
        return {"scale": tensor(sd[name + ".weight"]), "bias": tensor(sd[name + ".bias"])}

    params: cm.Params = {
        "stem": {"kernel": conv(sd[prefix + "embeddings.patch_embeddings.weight"]),
                 "bias": tensor(sd[prefix + "embeddings.patch_embeddings.bias"])},
        "stem_ln": vec(prefix + "embeddings.layernorm"),
        "final_ln": vec(prefix + "layernorm"),
    }
    for i, depth in enumerate(cfg.depths):
        f = f"{prefix}encoder.stages.{i}.layers.{{i}}."

        def lin(name):
            return {"kernel": stack(sd, f + name + ".weight", depth, t), "bias": stack(sd, f + name + ".bias", depth)}

        params[f"stage_{i}"] = {
            "dwconv": {"kernel": stack(sd, f + "dwconv.weight", depth, conv),
                       "bias": stack(sd, f + "dwconv.bias", depth)},
            "ln": {"scale": stack(sd, f + "layernorm.weight", depth), "bias": stack(sd, f + "layernorm.bias", depth)},
            "pw1": lin("pwconv1"),
            "pw2": lin("pwconv2"),
            "gamma": stack(sd, f + "layer_scale_parameter", depth),
        }
        if i > 0:
            base = f"{prefix}encoder.stages.{i}.downsampling_layer"
            params[f"down_{i}"] = {
                "ln": vec(base + ".0"),
                "conv": {"kernel": conv(sd[base + ".1.weight"]), "bias": tensor(sd[base + ".1.bias"])},
            }
    return params
