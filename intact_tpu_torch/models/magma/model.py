"""Native Magma-8B: ConvNeXt vision tower + projector + LLaMA-3 decode
(intact_tpu/models/magma/model.py).

One inference: the chat prompt holds a run of `image_token_id`
placeholders; ConvNeXt encodes the image, the projector maps its 256
features into the LM width, the i-th placeholder of a row takes the i-th
feature, and LLaMA prefills the right-padded prompt (causal) and greedily
decodes the action tokens against its K/V cache (models/llama.greedy_decode).
Tokens become continuous actions on the host (serve/decoding).

Weight import reads the microsoft/Magma-8B layout (`vision_tower.*` in
open_clip/timm ConvNeXt naming, `multi_modal_projector`, `language_model.*`
in LlamaForCausalLM naming), held against the meta-device init.

Over tensor ranks (serving at mesh.tensor > 1, `tensor_heads`) LLaMA runs
its local query and K/V heads, the embedding and the untied `lm_head` split
over the vocabulary (models/llama.py); ConvNeXt and the projector stay whole
on every rank (no tensor rule matches them).
"""

from __future__ import annotations

import logging
import re

import numpy as np
import torch
import torch.nn.functional as F

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models import convnext, llama
from intact_tpu_torch.models.common import DEFAULT_POLICY, DtypePolicy
from intact_tpu_torch.models.magma.config import MagmaConfig

log = logging.getLogger("intact_tpu_torch.magma")


# ---------------------------------------------------------------------------
# init / forward
# ---------------------------------------------------------------------------

def init_params(init: cm.Initializer, cfg: MagmaConfig) -> cm.Params:
    proj = {"linear_1": cm.dense_init(init, cfg.vision.dims[-1], cfg.lm.width)}
    if cfg.projector_layers == 2:
        proj["linear_2"] = cm.dense_init(init, cfg.lm.width, cfg.lm.width)
    return {
        "vision": convnext.init_params(init, cfg.vision),
        "projector": proj,
        "lm": llama.init_params(init, cfg.lm),
    }


def tensor_heads(cfg: MagmaConfig) -> dict:
    """{tower: (query heads, K/V heads)}: what the tensor axis must divide on
    LLaMA's attention projections (parallel/sharding.py)."""
    return {"lm": (cfg.lm.num_heads, cfg.lm.num_kv_heads)}


def init(cfg: MagmaConfig, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    """Random parameters from a generator seeded with `seed`, made on the
    device (CUDA unless `device` says otherwise) directly in `dtype`."""
    return init_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


# CLIP image normalization (the HF Magma processor's convention)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> CLIP-normalized fp32, on the device (serving
    ships uint8 frames: 4x fewer bytes to the card)."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=images_u8.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=images_u8.device)
    return (images_u8.to(torch.float32) / 255.0 - mean) / std


def encode_images(params, images, cfg: MagmaConfig, policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """images [B, H, W, 3] -> projected vision tokens [B, n_image_tokens, D_lm]."""
    feats, _ = convnext.encode(params["vision"], images, cfg.vision, policy)
    b, h, w, c = feats.shape
    x = cm.dense(params["projector"]["linear_1"], feats.reshape(b, h * w, c), policy)
    if "linear_2" in params["projector"]:
        x = cm.dense(params["projector"]["linear_2"], F.gelu(x, approximate="none"), policy)
    return x


def embed_prompt(params, images, tokens, masks, cfg: MagmaConfig, policy: DtypePolicy = DEFAULT_POLICY):
    """-> (embeds [B, T, D], masks): token embeddings with the vision
    features spliced at the `image_token_id` positions, in order: the i-th
    placeholder of a row takes that row's i-th vision token."""
    text = cm.embed_lookup(params["lm"]["embed"], tokens, policy)  # [B, T, D]
    vis = encode_images(params, images, cfg, policy)  # [B, N, D]
    is_img = tokens == cfg.image_token_id
    idx = (torch.cumsum(is_img.to(torch.int64), dim=1) - 1).clamp(0, vis.shape[1] - 1)
    gathered = torch.gather(vis, 1, idx[:, :, None].expand(-1, -1, vis.shape[-1]))
    return torch.where(is_img[:, :, None], gathered, text), masks


@torch.inference_mode()
def generate(params, images, tokens, masks, cfg: MagmaConfig, policy: DtypePolicy = DEFAULT_POLICY,
             max_new_tokens: int | None = None) -> torch.Tensor:
    """-> [B, max_new_tokens] greedy ids (n_action_tokens + 1 by default: the
    trained model emits the 7 action tokens, then EOS; callers take the
    leading n_action_tokens)."""
    n = max_new_tokens or cfg.n_action_tokens + 1
    embeds, mask = embed_prompt(params, images, tokens, masks, cfg, policy)
    return llama.greedy_decode(params["lm"], embeds, mask.to(torch.bool), n, cfg.lm, policy)


# LLaMA-3-instruct framing around the user turn: what
# apply_chat_template(add_generation_prompt=True) gives, with the <image>
# block at the start of the user content
_CHAT_PRE = "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\n"
_CHAT_POST = "<|eot_id|><|start_header_id|>assistant<|end_header_id|>\n\n"


def _encode_segment(tokenizer, text: str) -> list[int]:
    """A fixed template segment without padding or BOS: through the HF
    tokenizer where there is one, else the hash tokenizer's word ids."""
    hf = getattr(tokenizer, "tok", None)
    if hf is not None:
        return list(hf.encode(text, add_special_tokens=False))
    return [tokenizer._word_id(w) for w in text.split()]


def build_prompt(tokenizer, tasks: list[str], cfg: MagmaConfig):
    """[chat pre] + [image placeholders] + [instruction + chat post, padded]
    -> (tokens int32, masks bool) [B, n_pre + n_image_tokens +
    max_prompt_tokens], as numpy. The instruction is "\\nWhat action should
    the robot take to {task}?"; use_chat_template=False keeps only the BOS
    before the image block. An over-long instruction loses its own tail,
    never the chat suffix; a text token equal to image_token_id is remapped
    to the id below it."""
    if cfg.use_chat_template:
        pre_ids = _encode_segment(tokenizer, _CHAT_PRE)
    else:
        bos = getattr(tokenizer, "bos_id", None)
        hf = getattr(tokenizer, "tok", None)
        if bos is None and hf is not None:
            bos = hf.bos_token_id
        pre_ids = [bos] if bos is not None else []
    suffix_ids = _encode_segment(tokenizer, _CHAT_POST) if cfg.use_chat_template else []
    body_ids = [_encode_segment(tokenizer, f"\nWhat action should the robot take to {t}?") for t in tasks]

    n_pre, n_img, n_post = len(pre_ids), cfg.n_image_tokens, cfg.max_prompt_tokens
    n_body_max = max(n_post - len(suffix_ids), 0)
    tokens = np.zeros((len(tasks), n_pre + n_img + n_post), np.int32)
    masks = np.zeros_like(tokens, bool)
    tokens[:, :n_pre] = pre_ids
    tokens[:, n_pre:n_pre + n_img] = cfg.image_token_id
    masks[:, :n_pre + n_img] = True
    for i, body in enumerate(body_ids):
        if len(body) > n_body_max:
            log.warning("instruction %r truncated from %d to %d tokens to fit max_prompt_tokens=%d (chat suffix "
                        "preserved)", tasks[i][:60], len(body), n_body_max, n_post)
        ids = (body[:n_body_max] + suffix_ids)[:n_post]
        tokens[i, n_pre + n_img:n_pre + n_img + len(ids)] = ids
        masks[i, n_pre + n_img:n_pre + n_img + len(ids)] = True
    # a text token equal to the placeholder would take a vision embedding
    collisions = tokens == cfg.image_token_id
    collisions[:, n_pre:n_pre + n_img] = False
    if collisions.any():
        log.warning("%d text token(s) collided with image_token_id=%d; remapped", int(collisions.sum()),
                    cfg.image_token_id)
        tokens[collisions] = max(cfg.image_token_id - 1, 0)
    return tokens, masks


# ---------------------------------------------------------------------------
# HF checkpoint -> params
# ---------------------------------------------------------------------------

_TIMM_RULES = [
    (re.compile(r"^stem\.0\.(weight|bias)$"), r"embeddings.patch_embeddings.\1"),
    (re.compile(r"^stem\.1\.(weight|bias)$"), r"embeddings.layernorm.\1"),
    (re.compile(r"^stages\.(\d+)\.downsample\.0\.(weight|bias)$"), r"encoder.stages.\1.downsampling_layer.0.\2"),
    (re.compile(r"^stages\.(\d+)\.downsample\.1\.(weight|bias)$"), r"encoder.stages.\1.downsampling_layer.1.\2"),
    (re.compile(r"^stages\.(\d+)\.blocks\.(\d+)\.conv_dw\.(weight|bias)$"), r"encoder.stages.\1.layers.\2.dwconv.\3"),
    (re.compile(r"^stages\.(\d+)\.blocks\.(\d+)\.norm\.(weight|bias)$"), r"encoder.stages.\1.layers.\2.layernorm.\3"),
    (re.compile(r"^stages\.(\d+)\.blocks\.(\d+)\.mlp\.fc1\.(weight|bias)$"), r"encoder.stages.\1.layers.\2.pwconv1.\3"),
    (re.compile(r"^stages\.(\d+)\.blocks\.(\d+)\.mlp\.fc2\.(weight|bias)$"), r"encoder.stages.\1.layers.\2.pwconv2.\3"),
    (re.compile(r"^stages\.(\d+)\.blocks\.(\d+)\.gamma$"), r"encoder.stages.\1.layers.\2.layer_scale_parameter"),
    (re.compile(r"^head\.norm\.(weight|bias)$"), r"layernorm.\1"),
]


def timm_to_transformers(sd: dict, prefix: str) -> dict:
    """open_clip/timm ConvNeXt naming under `prefix` -> transformers
    ConvNextModel naming (what `convnext.from_hf_state_dict` reads). A key
    under `prefix` that no rule matches raises; a checkpoint without the
    pooling head's norm gets an identity one (Magma does not use the
    pooled output)."""
    from intact_tpu_torch.models.hf_import import tensor

    prefix = prefix + "." if prefix else ""
    out, saw_final_ln = {}, False
    for key, val in sd.items():
        if not key.startswith(prefix):
            continue
        rel = key[len(prefix):]
        for pat, repl in _TIMM_RULES:
            if pat.match(rel):
                new = pat.sub(repl, rel)
                saw_final_ln |= new.startswith("layernorm.")
                out[new] = val
                break
        else:
            raise KeyError(f"unrecognized timm ConvNeXt key: {key!r}")
    if not out:
        raise KeyError(f"no keys under vision prefix {prefix!r}")
    if not saw_final_ln:
        last = max(int(m.group(1)) for k in out if (m := re.match(r"encoder\.stages\.(\d+)\.", k)))
        dim = tensor(out[f"encoder.stages.{last}.layers.0.pwconv2.weight"]).shape[0]
        out["layernorm.weight"] = torch.ones((dim,), dtype=torch.float32)
        out["layernorm.bias"] = torch.zeros((dim,), dtype=torch.float32)
    return out


def from_hf_state_dict(
    sd: dict,
    cfg: MagmaConfig,
    vision_prefix: str = "vision_tower.clip_vision_model.trunk",
    projector_prefix: str = "multi_modal_projector",
    lm_prefix: str = "language_model.model",
    lm_head_key: str = "language_model.lm_head.weight",
) -> cm.Params:
    """A Magma checkpoint -> host parameter tree (CPU tensors in the
    checkpoint's dtype), every leaf's shape held against the init. The
    vision prefix is probed across the known layouts; vocabulary tables
    padded past cfg.lm.vocab_size lose their extra rows."""
    from intact_tpu_torch.models.hf_import import check_shapes, mlp2_from_sd, slice_vocab_rows

    for cand in (vision_prefix, "vision_tower.trunk", "vision_tower"):
        if any(k.startswith(cand + ".stem") or k.startswith(cand + ".stages") for k in sd):
            vision_prefix = cand
            break
    vis_sd = timm_to_transformers(sd, vision_prefix)
    lm = llama.from_hf_state_dict(sd, cfg.lm, prefix=lm_prefix, head_key=lm_head_key)
    lm["embed"]["embedding"] = slice_vocab_rows(lm["embed"]["embedding"], cfg.lm.vocab_size, "magma embed_tokens")
    if "lm_head" in lm:
        lm["lm_head"]["kernel"] = slice_vocab_rows(lm["lm_head"]["kernel"].T, cfg.lm.vocab_size,
                                                   "magma lm_head").T.contiguous()
    params: cm.Params = {
        "vision": convnext.from_hf_state_dict(vis_sd, cfg.vision, prefix=""),
        "projector": mlp2_from_sd(sd, projector_prefix, "projector"),
        "lm": lm,
    }
    return check_shapes(params, init(cfg, device="meta"))


def load_magma_checkpoint(path: str, cfg: MagmaConfig) -> cm.Params:
    """An HF snapshot directory (sharded `*.safetensors`) -> host parameter tree."""
    from intact_tpu_torch.models.hf_import import load_safetensors_dir

    return from_hf_state_dict(load_safetensors_dir(path), cfg)
