"""LeRobot Pi0 checkpoints (PyTorch safetensors) <-> the port's Pi0 tree
(intact_tpu/models/pi0/convert.py), as torch-to-torch renames.

The released INT-ACT policies (`juexzz/INTACT-pi0-finetune-bridge` etc.) are
LeRobot `PI0Policy` safetensors whose module tree is
`model.paligemma_with_expert.{paligemma,gemma_expert}` plus the projection
heads. The mapping:
  * torch Linear weights [out, in] -> kernels [in, out];
  * the SigLIP patch conv [D, 3, P, P] -> [P, P, 3, D];
  * per-layer keys `.layers.{i}.` -> leaves stacked [L, ...];
  * Gemma's RMSNorm weights keep their (1 + w) convention: copied.

`load_safetensors_checkpoint` reads a `model.safetensors` file or a snapshot
directory with json and torch alone (`hf_import`: the card has no
`safetensors`), values as fp32, as the reference's. `python -m intact_tpu_torch.models.pi0.import_lerobot` writes
the result as a port step dir.
"""

from __future__ import annotations

from pathlib import Path

import torch

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models.hf_import import load_safetensors_dir, read_safetensors, siglip_from_sd, stack, t, tensor
from intact_tpu_torch.models.pi0.config import Pi0Config

# prefixes inside the LeRobot PI0Policy state dict
P_VISION = "model.paligemma_with_expert.paligemma.vision_tower.vision_model"
P_PROJ = "model.paligemma_with_expert.paligemma.multi_modal_projector"
P_LM = "model.paligemma_with_expert.paligemma.language_model.model"
P_EXPERT = "model.paligemma_with_expert.gemma_expert.model"
P_HEADS = "model"
# (the port's head, the checkpoint's)
HEADS = (("state_proj", "state_proj"), ("action_in_proj", "action_in_proj"), ("action_out_proj", "action_out_proj"),
         ("time_mlp_in", "action_time_mlp_in"), ("time_mlp_out", "action_time_mlp_out"))
GEMMA_ATTN = (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "o_proj"))
GEMMA_MLP = (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj"))


def _gemma_blocks_from_sd(sd: dict, prefix: str, depth: int) -> cm.Params:
    fmt = prefix + ".layers.{i}."

    def lin(name):
        return {"kernel": stack(sd, fmt + name + ".weight", depth, t)}

    return {
        "blocks": {
            "ln1": {"scale": stack(sd, fmt + "input_layernorm.weight", depth)},
            "attn": {ours: lin("self_attn." + theirs) for ours, theirs in GEMMA_ATTN},
            "ln2": {"scale": stack(sd, fmt + "post_attention_layernorm.weight", depth)},
            "mlp": {ours: lin("mlp." + theirs) for ours, theirs in GEMMA_MLP},
        },
        "final_norm": {"scale": tensor(sd[prefix + ".norm.weight"])},
    }


def from_torch_state_dict(sd: dict, cfg: Pi0Config) -> cm.Params:
    """Flat {name: tensor or array} in LeRobot naming -> the port's Pi0 tree
    (CPU tensors in the checkpoint's dtype)."""
    heads = {ours: {"kernel": t(sd[f"{P_HEADS}.{theirs}.weight"]), "bias": tensor(sd[f"{P_HEADS}.{theirs}.bias"])}
             for ours, theirs in HEADS}
    return {
        "siglip": siglip_from_sd(sd, cfg.vision, P_VISION),
        "img_proj": {"kernel": t(sd[P_PROJ + ".linear.weight"]), "bias": tensor(sd[P_PROJ + ".linear.bias"])},
        "vlm_embed": {"embedding": tensor(sd[P_LM + ".embed_tokens.weight"])},
        "vlm": _gemma_blocks_from_sd(sd, P_LM, cfg.vlm.depth),
        "expert": _gemma_blocks_from_sd(sd, P_EXPERT, cfg.expert.depth),
        **heads,
    }


def to_torch_state_dict(params: cm.Params, cfg: Pi0Config) -> dict:
    """The inverse mapping -> flat {name: CPU tensor} in LeRobot naming."""
    p = cm.tree_map(lambda x: x.detach().to("cpu"), params)
    sd: dict[str, torch.Tensor] = {}

    def put_linear(name, node):
        sd[name + ".weight"] = node["kernel"].T.contiguous()
        if "bias" in node:
            sd[name + ".bias"] = node["bias"]

    for ours, theirs in HEADS:
        put_linear(f"{P_HEADS}.{theirs}", p[ours])
    put_linear(P_PROJ + ".linear", p["img_proj"])
    sd[P_LM + ".embed_tokens.weight"] = p["vlm_embed"]["embedding"]
    for prefix, tree, depth in ((P_LM, p["vlm"], cfg.vlm.depth), (P_EXPERT, p["expert"], cfg.expert.depth)):
        b = tree["blocks"]
        for i in range(depth):
            base = f"{prefix}.layers.{i}."
            sd[base + "input_layernorm.weight"] = b["ln1"]["scale"][i]
            sd[base + "post_attention_layernorm.weight"] = b["ln2"]["scale"][i]
            for ours, theirs in GEMMA_ATTN:
                sd[base + f"self_attn.{theirs}.weight"] = b["attn"][ours]["kernel"][i].T.contiguous()
            for ours, theirs in GEMMA_MLP:
                sd[base + f"mlp.{theirs}.weight"] = b["mlp"][ours]["kernel"][i].T.contiguous()
        sd[prefix + ".norm.weight"] = tree["final_norm"]["scale"]

    v = p["siglip"]
    sd[P_VISION + ".embeddings.patch_embedding.weight"] = v["patch_embed"]["kernel"].permute(3, 2, 0, 1).contiguous()
    sd[P_VISION + ".embeddings.patch_embedding.bias"] = v["patch_embed"]["bias"]
    sd[P_VISION + ".embeddings.position_embedding.weight"] = v["pos_embed"][0]
    vb = v["blocks"]
    for i in range(cfg.vision.depth):
        base = f"{P_VISION}.encoder.layers.{i}."
        for ln, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            sd[base + theirs + ".weight"] = vb[ln]["scale"][i]
            sd[base + theirs + ".bias"] = vb[ln]["bias"][i]
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            put_linear(base + f"self_attn.{theirs}", {k: x[i] for k, x in vb["attn"][ours].items()})
        for m in ("fc1", "fc2"):
            put_linear(base + f"mlp.{m}", {k: x[i] for k, x in vb["mlp"][m].items()})
    sd[P_VISION + ".post_layernorm.weight"] = v["ln_post"]["scale"]
    sd[P_VISION + ".post_layernorm.bias"] = v["ln_post"]["bias"]
    return sd


def load_safetensors_checkpoint(path: str | Path, cfg: Pi0Config) -> cm.Params:
    """A LeRobot pi0 `model.safetensors` file, or the snapshot directory
    holding it (or its shards) -> the port's Pi0 tree, CPU tensors in fp32."""
    path = Path(path)
    raw = load_safetensors_dir(path) if path.is_dir() else read_safetensors(path)
    # copies: a view of the mapped file would carry the whole file's storage into a torch.save
    sd = {k: v.to(torch.float32, copy=True) for k, v in raw.items()}
    return from_torch_state_dict(sd, cfg)
