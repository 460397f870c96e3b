"""Shared helpers of the HF-checkpoint importers (intact_tpu/models/hf_import.py
and the SigLIP part of intact_tpu/models/pi0/convert.py).

Importers map an HF state dict ({name: numpy array or tensor}) onto the
port's parameter tree as host (CPU) tensors in the checkpoint's dtype; the
serving wrapper moves them to the card (and quantizes them there when it
serves int8). `load_safetensors_dir` reads a sharded safetensors snapshot
with json and torch alone, bf16 included; `check_shapes` holds an imported
tree against the model's meta-device init, leaf by leaf.
"""

from __future__ import annotations

import json
import logging
import mmap
from pathlib import Path

import torch

from intact_tpu_torch.models import common as cm

log = logging.getLogger("intact_tpu_torch.hf_import")

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}


def tensor(x) -> torch.Tensor:
    """An array or tensor as a CPU tensor (numpy arrays are not copied)."""
    return x.cpu() if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def t(x) -> torch.Tensor:
    """torch Linear weight [out, in] -> kernel [in, out]."""
    return tensor(x).T.contiguous()


def stack(sd: dict, fmt: str, n: int, transform=tensor) -> torch.Tensor:
    """Per-layer entries fmt.format(i=i), i < n, stacked [n, ...]."""
    return torch.stack([transform(sd[fmt.format(i=i)]) for i in range(n)])


def read_safetensors(path: str | Path) -> dict:
    """One safetensors file -> {name: CPU tensor}: the 8-byte little-endian
    header length, the JSON header, then each tensor's bytes at its
    data_offsets past the header. The file is mapped copy-on-write, so
    tensors read their bytes on first touch."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which this loader does not read")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = (end - begin) // dtype.itemsize
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(buf, dtype=dtype, count=count, offset=8 + n + begin)
        out[name] = flat.reshape(shape)
    return out


def load_safetensors_dir(path: str | Path) -> dict:
    """Merge the shards of an HF snapshot directory into one state dict: the
    files the index (`*.safetensors.index.json`, its weight_map) names, else
    every `*.safetensors` there."""
    path = Path(path)
    indexes = sorted(path.glob("*.safetensors.index.json"))
    if indexes:
        files = sorted({path / f for idx in indexes for f in json.loads(idx.read_text())["weight_map"].values()})
    else:
        files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    sd: dict = {}
    for f in files:
        sd.update(read_safetensors(f))
    return sd


def check_shapes(params: cm.Params, template: cm.Params) -> cm.Params:
    """Hold an imported tree against `template` (the model's init on the meta
    device): every leaf present with the template's shape, else raise
    (naming, transpose and GQA-layout slips fail here, not at serving time).
    Returns params."""
    got = cm.flatten_paths(params)
    for path, want in cm.flatten_paths(template).items():
        if path not in got:
            raise KeyError(f"missing imported weight at {path}")
        if tuple(got[path].shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {path}: imported {tuple(got[path].shape)} != expected "
                             f"{tuple(want.shape)}")
    return params


def mlp2_from_sd(sd: dict, prefix: str, what: str) -> cm.Params:
    """A 2-layer MLP under any common naming ({linear_1, linear_2},
    {proj.0, proj.2} or nn.Sequential's {0, 2}) -> {"linear_1", "linear_2"}."""

    def lin(name):
        return {"kernel": t(sd[f"{prefix}.{name}.weight"]), "bias": tensor(sd[f"{prefix}.{name}.bias"])}

    names = [k[len(prefix) + 1:] for k in sd if k.startswith(prefix + ".")]
    for first, second in (("linear_1", "linear_2"), ("proj.0", "proj.2"), ("0", "2")):
        if any(n.startswith(first + ".") for n in names):
            out = {"linear_1": lin(first)}
            if any(n.startswith(second + ".") for n in names):
                out["linear_2"] = lin(second)
            return out
    raise KeyError(f"no {what} weights under {prefix!r} (saw {sorted(names)[:4]}...)")


def slice_vocab_rows(arr, vocab_size: int, what: str) -> torch.Tensor:
    """Keep the leading `vocab_size` rows of a table a checkpoint padded past
    the vocabulary; a table with fewer rows raises."""
    arr = tensor(arr)
    if arr.shape[0] < vocab_size:
        raise ValueError(f"{what}: checkpoint has {arr.shape[0]} vocab rows < configured {vocab_size}")
    if arr.shape[0] > vocab_size:
        log.info("%s: slicing %d checkpoint vocab rows to configured %d", what, arr.shape[0], vocab_size)
        arr = arr[:vocab_size]
    return arr


def siglip_from_sd(sd: dict, cfg, prefix: str) -> cm.Params:
    """transformers SiglipVisionModel naming under `prefix` (its
    vision_model) -> the port's SigLIP tree: the patch conv [D, 3, P, P] as
    [P, P, 3, D], Linear weights transposed, layers stacked."""
    fmt = prefix + ".encoder.layers.{i}."
    n = cfg.depth

    def lin(name):
        return {"kernel": stack(sd, fmt + name + ".weight", n, t), "bias": stack(sd, fmt + name + ".bias", n)}

    def norm(name):
        return {"scale": stack(sd, fmt + name + ".weight", n), "bias": stack(sd, fmt + name + ".bias", n)}

    conv = tensor(sd[prefix + ".embeddings.patch_embedding.weight"])
    return {
        "patch_embed": {"kernel": conv.permute(2, 3, 1, 0).contiguous(),
                        "bias": tensor(sd[prefix + ".embeddings.patch_embedding.bias"])},
        "pos_embed": tensor(sd[prefix + ".embeddings.position_embedding.weight"])[None],
        "blocks": {
            "ln1": norm("layer_norm1"),
            "attn": {"q": lin("self_attn.q_proj"), "k": lin("self_attn.k_proj"), "v": lin("self_attn.v_proj"),
                     "o": lin("self_attn.out_proj")},
            "ln2": norm("layer_norm2"),
            "mlp": {"fc1": lin("mlp.fc1"), "fc2": lin("mlp.fc2")},
        },
        "ln_post": {"scale": tensor(sd[prefix + ".post_layernorm.weight"]),
                    "bias": tensor(sd[prefix + ".post_layernorm.bias"])},
    }
