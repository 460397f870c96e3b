"""Pi0FAST: teacher-forced autoregressive training and a greedy KV-cached
decode (intact_tpu/models/pi0fast/model.py).

Layout: [image patches | language | state token] form one full-attention
prefix block; the action-token suffix is causal (each token starts a new
block). The output head is tied to the input embedding: logits = h E^T in
the compute dtype, then fp32. Decoding is constrained to the action-token
tail of the vocabulary and runs n_action_tokens single-token steps of the
whole trunk against a K/V cache of P + n_action_tokens slots: step s writes
its K/V into slot P + s, the same slot for every row, and rotates each row
at its own position prefix_count + s (language padding differs per row).
Step 0 feeds the learned `action_start` embedding, later steps the embedded
previous token times sqrt(width).

Interface as the other model modules (init / compute_loss / sample_actions),
so the trainer, Pi0Policy and the serving wrapper apply.

Over tensor ranks (serving and the standard training step at mesh.tensor
> 1, `tensor_heads`) SigLIP and the trunk run their local heads
(models/gemma.py; the one K/V head whole on every rank, so the cache holds it
whole), the table is split over its vocabulary: a rank looks up its rows,
forms the logits of its rows (of the action window when decoding: the
window's tail rows sit on the last rank or ranks), the greedy token is
reduced over tensor (`tensor_parallel.vocab_argmax`) and the training loss is
the vocabulary-parallel cross entropy (`tensor_parallel.vocab_cross_entropy`).
"""

from __future__ import annotations

import torch

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models import gemma, siglip
from intact_tpu_torch.models.common import DEFAULT_POLICY, DtypePolicy
from intact_tpu_torch.models.pi0 import model as pi0
from intact_tpu_torch.models.pi0fast.config import Pi0FASTConfig
from intact_tpu_torch.ops.attention import xla_attention
from intact_tpu_torch.ops.masks import make_att_2d_masks
from intact_tpu_torch.parallel import tensor as tensor_parallel
from intact_tpu_torch.parallel.sharding import held

GREEDY = True  # sample_actions draws no noise: a serving group broadcasts none (serve/policy_wrapper.py)


def init_params(init: cm.Initializer, cfg: Pi0FASTConfig) -> cm.Params:
    return {
        "siglip": siglip.init_params(init, cfg.vision),
        "img_proj": cm.dense_init(init, cfg.vision.width, cfg.vlm.width),
        "vlm_embed": gemma.init_embed_params(init, cfg.vlm),
        "vlm": gemma.init_blocks_params(init, cfg.vlm),
        "state_proj": cm.dense_init(init, cfg.max_state_dim, cfg.vlm.width),
        "action_start": init.normal((1, 1, cfg.vlm.width), 0.02),
    }


def tensor_heads(cfg: Pi0FASTConfig) -> dict:
    """{tower: (query heads, K/V heads)}: what the tensor axis must divide on
    each tower's attention projections (parallel/sharding.py)."""
    return {"siglip": (cfg.vision.num_heads, cfg.vision.num_heads), "vlm": (cfg.vlm.num_heads, cfg.vlm.num_kv_heads)}


def init(cfg: Pi0FASTConfig, seed: int = 0, device=None, dtype=torch.float32) -> cm.Params:
    """Random parameters from a generator seeded with `seed`, made on the
    device (CUDA unless `device` says otherwise) directly in `dtype`."""
    return init_params(cm.Initializer(seed, cm.resolve_device(device), dtype), cfg)


# ---------------------------------------------------------------------------
# action <-> token
# ---------------------------------------------------------------------------

def tokenize_actions(actions: torch.Tensor, cfg: Pi0FASTConfig) -> torch.Tensor:
    """[B, chunk, dim] normalized actions -> [B, chunk*dim] vocab ids (int64),
    binned uniformly into the tail of the vocabulary."""
    a = actions[..., : cfg.max_action_dim].clamp(cfg.action_low, cfg.action_high)
    idx = torch.floor((a - cfg.action_low) / (cfg.action_high - cfg.action_low) * cfg.n_action_bins).long()
    idx = idx.clamp(0, cfg.n_action_bins - 1)
    return (cfg.vlm.vocab_size - idx - 1).reshape(idx.shape[0], -1)


def detokenize_actions(ids: torch.Tensor, cfg: Pi0FASTConfig) -> torch.Tensor:
    """[B, chunk*dim] vocab ids -> [B, chunk, dim] bin-center actions (fp32)."""
    idx = (cfg.vlm.vocab_size - ids.long() - 1).clamp(0, cfg.n_action_bins - 1)
    step = (cfg.action_high - cfg.action_low) / cfg.n_action_bins
    a = cfg.action_low + (idx.to(torch.float32) + 0.5) * step
    return a.reshape(ids.shape[0], cfg.chunk_size, cfg.max_action_dim)


# ---------------------------------------------------------------------------
# embedding and the tied head
# ---------------------------------------------------------------------------

def embed_prefix(params, images, img_masks, lang_tokens, lang_masks, state, cfg: Pi0FASTConfig,
                 policy: DtypePolicy = DEFAULT_POLICY):
    """Pi0's prefix (image patches, language) plus the projected state as one
    more token of the same full-attention block -> (embs, pad, att)."""
    embs, pad, att = pi0.embed_prefix(params, images, img_masks, lang_tokens, lang_masks, cfg, policy)
    state_tok = cm.dense(params["state_proj"], policy.cast(state), policy)[:, None, :]
    embs = torch.cat([embs, state_tok], dim=1)
    pad = torch.cat([pad, pad.new_ones((pad.shape[0], 1))], dim=1)
    att = torch.cat([att, att.new_zeros((att.shape[0], 1))], dim=1)
    return embs, pad, att


def embed_tokens(params, ids: torch.Tensor, cfg: Pi0FASTConfig, policy: DtypePolicy = DEFAULT_POLICY):
    """Action-token ids [B, T] -> input embeddings [B, T, D], scaled by
    sqrt(width) in the compute dtype (Gemma convention)."""
    emb = cm.embed_lookup(params["vlm_embed"], ids, policy)
    return emb * torch.tensor(cfg.vlm.width**0.5, dtype=emb.dtype, device=emb.device)


def _logits(params, h: torch.Tensor, policy: DtypePolicy, first: int = 0) -> torch.Tensor:
    """Tied head: h [..., D] against the embedding rows first.. -> fp32
    [..., V - first] (of a vocabulary-parallel table, this rank's rows
    first..). The product runs in the compute dtype, as the reference's
    does, so its ties are the reference's ties."""
    emb = cm.whole(params["vlm_embed"]["embedding"], slice(first, None)).to(policy.compute_dtype)
    return (h.to(policy.compute_dtype) @ emb.T).to(torch.float32)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def compute_loss(params, rng, batch: dict, cfg: Pi0FASTConfig, policy: DtypePolicy = DEFAULT_POLICY,
                 train: bool = True, noise=None, time=None):
    """Teacher-forced cross entropy over the action tokens -> (mean loss,
    {"l2_loss", "ce_loss": mean loss, "token_accuracy", "losses": [B, T]}).

    Targets: the in-graph binning of batch["actions"], or precomputed
    batch["action_tokens"] [B, T] (FAST DCT+BPE ids) with an optional
    "action_token_mask". Loss and accuracy average over the same kept
    tokens (the token mask, else not action_is_pad). The loss draws nothing:
    `rng`, `noise` and `time` are unused (Pi0's flow-matching draws, taken
    so that one trainer calls every family alike). Each trunk layer is
    recomputed in the backward (gemma.prefill under autograd). Over tensor
    the logits are this rank's vocabulary columns, the cross entropy and the
    accuracy's argmax reduced over tensor (`tensor_parallel.vocab_cross_entropy`,
    `vocab_argmax`)."""
    del rng, train, noise, time
    # the tied table serves the language lookup, the teacher-forced inputs and
    # the head: over fsdp ranks it is gathered once, and its three gradients
    # meet in autograd before its one reduce-scatter; over tensor a rank holds
    # its vocabulary rows, and its lookups' rows and its head's columns are
    # both gradients of those rows
    tp = tensor_parallel.of(params["vlm_embed"])
    params = {**params, "vlm_embed": cm.gathered(params["vlm_embed"])}
    if "action_tokens" in batch:
        targets = batch["action_tokens"].long()
        token_keep = batch.get("action_token_mask")
        token_keep = torch.ones_like(targets, dtype=torch.bool) if token_keep is None else token_keep.to(torch.bool)
    else:
        targets = tokenize_actions(batch["actions"], cfg)
        token_keep = None
    b, t = targets.shape

    pre_embs, pre_pad, pre_att = embed_prefix(params, batch["images"], batch["img_masks"], batch["lang_tokens"],
                                              batch["lang_masks"], batch["state"], cfg, policy)
    # teacher forcing: suffix inputs = [start, a_0 .. a_{T-2}], a causal chain
    start = policy.cast(params["action_start"]).expand(b, 1, cfg.vlm.width)
    suf_embs = torch.cat([start, embed_tokens(params, targets[:, :-1], cfg, policy)], dim=1)
    embs = torch.cat([pre_embs, suf_embs], dim=1)
    pad = torch.cat([pre_pad, pre_pad.new_ones((b, t))], dim=1)
    att = torch.cat([pre_att, pre_att.new_ones((b, t))], dim=1)
    positions = torch.cumsum(pad.to(torch.int32), dim=1) - 1

    out, _ = gemma.prefill(params["vlm"], embs, make_att_2d_masks(pad, att), positions, cfg.vlm, policy,
                           cfg.attention_impl)
    # [B, T, V] (over tensor this rank's columns: the head's input through copy_in, its gradient summed)
    logits = _logits(params, tensor_parallel.copy_in(out[:, -t:], tp), policy)
    nll = tensor_parallel.vocab_cross_entropy(logits, targets, tp, cfg.vlm.vocab_size)

    if token_keep is not None:
        keep = token_keep
    elif "action_is_pad" in batch:
        keep = (~batch["action_is_pad"]).repeat_interleave(cfg.max_action_dim, dim=1)
    else:
        keep = torch.ones_like(targets, dtype=torch.bool)
    keep_f = keep.to(nll.dtype)
    n_keep = keep_f.sum().clamp_min(1)
    loss = (nll * keep_f).sum() / n_keep
    acc = ((tensor_parallel.vocab_argmax(logits.detach(), tp) == targets).to(torch.float32) * keep_f).sum() / n_keep
    return loss, {"l2_loss": loss, "ce_loss": loss, "token_accuracy": acc, "losses": nll * keep_f}


# ---------------------------------------------------------------------------
# greedy decode
# ---------------------------------------------------------------------------

def prefix_cache(params, images, img_masks, lang_tokens, lang_masks, state, cfg: Pi0FASTConfig,
                 policy: DtypePolicy = DEFAULT_POLICY):
    """The prefix through SigLIP, the projector and `gemma.prefill(kv_only=True)`
    into a cache with n_action_tokens free slots after it -> (kv_cache,
    pre_pad)."""
    pre_embs, pre_pad, pre_att = embed_prefix(params, images, img_masks, lang_tokens, lang_masks, state, cfg,
                                              policy)
    pre_pos = torch.cumsum(pre_pad.to(torch.int32), dim=1) - 1
    _, kv_cache = gemma.prefill(params["vlm"], pre_embs, make_att_2d_masks(pre_pad, pre_att), pre_pos, cfg.vlm,
                                policy, cfg.attention_impl, kv_only=True,
                                cache_len=pre_pad.shape[1] + cfg.n_action_tokens)
    return kv_cache, pre_pad


def decode_token(params, x, kv_cache, slot: int, key_valid, position, cfg: Pi0FASTConfig,
                 policy: DtypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """One token x [B, 1, D] through every trunk layer against the cache, its
    K/V written into `slot` of every row; key_valid bool [B, slots] marks the
    slots it reads (its own included), position [B, 1] its RoPE position.
    The attention is the plain path, as the reference's XLA attention.
    -> final-normed [B, D]."""
    ck, cv = kv_cache
    vc = cfg.vlm
    scale = vc.head_dim**-0.5
    mask = key_valid[:, None, :]
    tp = tensor_parallel.of(params["vlm"])
    for i in range(vc.depth):
        bp = cm.layer(params["vlm"]["blocks"], i)
        q, k, v = gemma._qkv(bp, cm.rms_norm(bp["ln1"], x, vc.norm_eps), position, vc, policy, tp)
        ck[i, :, slot], cv[i, :, slot] = k[:, 0], v[:, 0]
        # the rank's heads among zero ones, at one card's shapes, as in gemma.decode
        q, own = tensor_parallel.whole_groups(q, gemma._attention_region(bp, vc, tp), vc.num_heads, vc.num_kv_heads)
        x = gemma._post_attention(bp, x, xla_attention(q, ck[i], cv[i], mask, scale)[:, :, own], vc, policy, tp)
    return cm.rms_norm(params["vlm"]["final_norm"], x, vc.norm_eps)[:, 0]


@torch.inference_mode()
def sample_actions(params, generator, images, img_masks, lang_tokens, lang_masks, state, cfg: Pi0FASTConfig,
                   policy: DtypePolicy = DEFAULT_POLICY, noise=None, return_tokens: bool = False) -> torch.Tensor:
    """Greedy KV-cached decode -> [B, chunk, max_action_dim] fp32 bin-center
    actions, or with return_tokens the generated ids [B, T] (int32), which
    the FAST path decodes on the host (fast_tokenizer.decode_batch). The
    argmax runs over the last action_vocab_size (else n_action_bins) ids;
    the product is formed against those rows of the table alone, since
    nothing else is read. Over a vocabulary-parallel table a rank forms its
    rows of the window and the argmax is reduced over tensor.
    `generator` and `noise` are unused (greedy)."""
    del generator, noise
    (ck, cv), pre_pad = prefix_cache(params, images, img_masks, lang_tokens, lang_masks, state, cfg, policy)
    b, p_len = pre_pad.shape
    first = cfg.vlm.vocab_size - (cfg.action_vocab_size or cfg.n_action_bins)
    tp = tensor_parallel.of(params["vlm_embed"])
    lo, offset = tensor_parallel.vocab_window(tp, held(params["vlm_embed"]["embedding"]).shape[0], first)
    key_valid = torch.cat([pre_pad, pre_pad.new_zeros((b, cfg.n_action_tokens))], dim=1)
    prefix_count = pre_pad.sum(dim=1, keepdim=True).to(torch.int32)  # [B, 1]
    x = policy.cast(params["action_start"]).expand(b, 1, cfg.vlm.width)
    tokens = []
    for s in range(cfg.n_action_tokens):
        key_valid[:, p_len + s] = True
        h = decode_token(params, x, (ck, cv), p_len + s, key_valid, prefix_count + s, cfg, policy)
        tokens.append(first + tensor_parallel.vocab_argmax(_logits(params, h, policy, lo), tp, offset))
        x = embed_tokens(params, tokens[-1][:, None], cfg, policy)
    tokens = torch.stack(tokens, dim=1)
    if return_tokens:
        return tokens.to(torch.int32)
    return detokenize_actions(tokens, cfg)
