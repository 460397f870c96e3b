"""The PyTorch port's Pi0FAST against the JAX package's, on the CPU.

Both run `Pi0FASTConfig.tiny()` in fp32 (`DtypePolicy(float32, float32)` on
both sides) on parameters made by the JAX `pi0fast.init` and carried across
by `intact_tpu_torch.convert.from_jax_params`; inputs come from a seeded
numpy generator, with two rows of different language length. The JAX side
runs compiled (`jax.jit`), as the reference trains and serves. Tolerances,
each with its reason:
  * embeddings 1e-5: the same fp32 ops, products summed in another order;
  * loss 1e-5 relative, token accuracy equal: fp32 sums in another order
    over a few hundred terms;
  * gradients 1e-4 relative L2 per leaf: the backward sums in another order
    again, through two layers (SigLIP's key biases, whose exact gradient is
    0, within 1e-6 of the gradient's norm);
  * tokens, and so the bin-center actions, equal: greedy decoding is
    discontinuous, and a tie within the tiny model's fp32 rounding would
    flip a token (none is near one on these inputs);
  * the FAST tokenizer and the batched adapter: equal (copies of the
    reference's host code), but the adapter's float frames within 1 fp32 ulp:
    the reference normalizes them with a native fused multiply-add where it
    can build one, the port as the reference's numpy fallback does.
"""

import dataclasses
import logging
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intact_tpu.models import common as jcm
from intact_tpu.models.pi0fast import model as jfast
from intact_tpu.models.pi0fast.config import Pi0FASTConfig as JCfg
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models import gemma as tgemma
from intact_tpu_torch.models.pi0fast import model as tfast
from intact_tpu_torch.models.pi0fast.config import Pi0FASTConfig as TCfg
from intact_tpu_torch.ops.masks import make_att_2d_masks

REPO = Path(__file__).resolve().parent.parent
EV_YAML = REPO / "config/experiment/simplerMS3/pi0fast_finetune_bridge_ev.yaml"
TRAIN_YAML = REPO / "config/train/pi0fast_finetune_bridge.yaml"
STATS = str(REPO / "config/dataset/bridge_statistics.json")
J32 = jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
T32 = tcm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
INPUTS = ("images", "img_masks", "lang_tokens", "lang_masks", "state")


@pytest.fixture(scope="module")
def cfgs():
    return JCfg.tiny(), TCfg.tiny()


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jax.jit(jfast.init, static_argnums=1)(jax.random.key(0), cfgs[0])


@pytest.fixture(scope="module")
def tparams(cfgs, jparams):
    return convert.from_jax_params(jax.tree.map(np.asarray, jparams), cfgs[1], device="cpu")


@pytest.fixture(scope="module")
def batch(cfgs):
    cfg = cfgs[0]
    rng = np.random.default_rng(1)
    b, s = 2, cfg.vision.image_size
    lang_masks = np.zeros((b, cfg.tokenizer_max_length), bool)
    lang_masks[0, :5] = True
    lang_masks[1, :3] = True  # ragged language padding: per-row positions differ
    action_is_pad = np.zeros((b, cfg.chunk_size), bool)
    action_is_pad[1, -1] = True
    return {
        "images": rng.uniform(-1, 1, (b, cfg.num_cameras, s, s, 3)).astype(np.float32),
        "img_masks": np.ones((b, cfg.num_cameras), bool),
        "lang_tokens": rng.integers(0, 200, (b, cfg.tokenizer_max_length)).astype(np.int32),
        "lang_masks": lang_masks,
        "state": rng.standard_normal((b, cfg.max_state_dim), dtype=np.float32),
        "actions": rng.uniform(-2, 2, (b, cfg.chunk_size, cfg.max_action_dim)).astype(np.float32),
        "action_is_pad": action_is_pad,
    }


@pytest.fixture(scope="module")
def fast_tokens(cfgs, batch):
    """FAST DCT+BPE targets of the batch's actions, fitted on a synthetic corpus."""
    from intact_tpu.models.pi0fast.fast_tokenizer import FastTokenizer

    cfg = cfgs[0]
    rng = np.random.default_rng(0)
    tok = FastTokenizer(scale=20.0, max_token=64).fit(
        rng.uniform(-0.8, 0.8, (16, cfg.chunk_size, cfg.max_action_dim)).astype(np.float32))
    ids, mask = tok.encode_batch(batch["actions"] * 0.4, max_len=cfg.n_action_tokens,
                                 vocab_size=cfg.vlm.vocab_size)
    mask[1, -1] = False  # a kept-token mask with a dropped position
    return ids, mask


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_loss(cfg):
    return jax.jit(lambda p, b: jfast.compute_loss(p, jax.random.key(0), b, cfg, J32))


# ---------------------------------------------------------------------------
# weights, tokens, embeddings
# ---------------------------------------------------------------------------

class TestWeightBridge:
    def test_fills_every_parameter(self, jparams, tparams):
        jleaves = jax.tree_util.tree_leaves_with_path(jparams)
        assert len(jleaves) == len(tcm.tree_leaves(tparams))
        assert set(tparams) == {"siglip", "img_proj", "vlm_embed", "vlm", "state_proj", "action_start"}
        for path, leaf in jleaves:
            node = tparams
            for p in path:
                node = node[p.key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))

    def test_raises_on_leftover_and_missing(self, cfgs, jparams):
        tree = jax.tree.map(np.asarray, jparams)
        with pytest.raises(ValueError, match="unconsumed"):
            convert.from_jax_params({**tree, "expert": {"x": np.zeros(3)}}, cfgs[1], device="cpu")
        tree = dict(tree)
        del tree["action_start"]
        with pytest.raises(ValueError, match="missing"):
            convert.from_jax_params(tree, cfgs[1], device="cpu")

    def test_quantized_tree_carries_across(self, cfgs, jparams, tparams):
        """The int8 serving tree: img_proj and the block kernels int8,
        state_proj and the tied table (vlm_embed, not `lm/embed`) fp."""
        jq = jax.jit(jcm.quantize_params)(jparams)
        tq = convert.from_jax_params(jax.tree.map(np.asarray, jq), cfgs[1], device="cpu")
        flat = tcm.flatten_paths(tq)
        assert flat["img_proj/kernel_q"].dtype == torch.int8 and "state_proj/kernel" in flat
        assert "vlm_embed/embedding" in flat
        assert tcm.flatten_paths(tcm.quantize_params(tparams)).keys() == flat.keys()


def test_tokenize_detokenize_match(cfgs):
    jc, tc = cfgs
    a = np.random.default_rng(0).uniform(-4, 4, (3, tc.chunk_size, tc.max_action_dim)).astype(np.float32)
    ids = tfast.tokenize_actions(torch.from_numpy(a), tc)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jfast.tokenize_actions(jnp.asarray(a), jc)))
    np.testing.assert_array_equal(tfast.detokenize_actions(ids, tc).numpy(),
                                  np.asarray(jfast.detokenize_actions(jnp.asarray(ids.numpy()), jc)))


def test_embed_prefix_matches(cfgs, jparams, tparams, batch):
    jc, tc = cfgs
    je, jpad, jatt = jfast.embed_prefix(jparams, *(jnp.asarray(batch[k]) for k in INPUTS), jc, J32)
    te, tpad, tatt = tfast.embed_prefix(tparams, *(torch.from_numpy(batch[k]) for k in INPUTS), tc, T32)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    np.testing.assert_array_equal(tatt.numpy(), np.asarray(jatt))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("targets", ["binning", "fast_tokens"])
def test_compute_loss_matches(cfgs, jparams, tparams, batch, fast_tokens, targets):
    jc, tc = cfgs
    b = dict(batch)
    if targets == "fast_tokens":
        b["action_tokens"], b["action_token_mask"] = fast_tokens
    jl, jaux = jax_loss(jc)(jparams, jax_batch(b))
    tl, taux = tfast.compute_loss(tparams, None, torch_batch(b), tc, T32)
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert taux["ce_loss"].item() == taux["l2_loss"].item() == tl.item()
    assert taux["token_accuracy"].item() == float(jaux["token_accuracy"])
    np.testing.assert_allclose(taux["losses"].numpy(), np.asarray(jaux["losses"]), rtol=1e-5, atol=1e-6)


def test_gradients_match(cfgs, jparams, tparams, batch):
    jc, tc = cfgs
    jg = jax.jit(jax.grad(lambda p, b: jfast.compute_loss(p, jax.random.key(0), b, jc, J32)[0]))(
        jparams, jax_batch(batch))
    flat = tcm.flatten_paths(tparams)
    views = {k: v.detach().clone().requires_grad_() for k, v in flat.items()}
    loss, _ = tfast.compute_loss(tcm.unflatten_paths(views), None, torch_batch(batch), tc, T32)
    grads = dict(zip(views, torch.autograd.grad(loss, list(views.values()))))
    jflat = tcm.flatten_paths(jax.tree.map(np.asarray, jg))
    assert jflat.keys() == grads.keys()
    # a key bias adds q.b to every logit of a query row, which the softmax
    # cancels: its exact gradient is 0 and both sides hold rounding noise
    shift = [k for k in jflat if k.endswith("attn/k/bias")]
    total = np.sqrt(sum(np.square(g).sum() for g in jflat.values()))
    assert shift and all(max(np.linalg.norm(jflat[k]), grads[k].norm().item()) <= 1e-6 * total for k in shift)
    worst = max((rel(grads[k].numpy(), jflat[k]), k) for k in jflat if k not in shift)
    assert worst[0] <= 1e-4, worst
    assert all(np.abs(jflat[k]).sum() > 0 for k in ("action_start", "state_proj/kernel", "vlm_embed/embedding"))


def test_prefill_checkpointed_equals_plain_forward(cfgs, tparams, batch):
    """Under autograd prefill runs each layer under torch.utils.checkpoint:
    its output equals the no_grad forward's, it builds no cache, and it
    refuses the cache-only modes."""
    tc = cfgs[1]
    embs, pad, att = tfast.embed_prefix(tparams, *(torch.from_numpy(batch[k]) for k in INPUTS), tc, T32)
    mask, pos = make_att_2d_masks(pad, att), torch.cumsum(pad.to(torch.int32), dim=1) - 1
    x = embs.detach()
    vlm = tcm.tree_map(lambda t: t.detach().clone().requires_grad_(), tparams["vlm"])
    xin = x.clone().requires_grad_()
    out, cache = tgemma.prefill(vlm, xin, mask, pos, tc.vlm, T32, "pallas")
    assert cache is None and out.grad_fn is not None
    grads = torch.autograd.grad((out * out.detach()).sum(), [xin] + tcm.tree_leaves(vlm))
    assert all(torch.isfinite(g).all() for g in grads) and grads[0].abs().sum() > 0
    with torch.no_grad():
        ref, (k, _) = tgemma.prefill(tparams["vlm"], x, mask, pos, tc.vlm, T32, "pallas")
    assert torch.equal(ref, out.detach()) and k.shape[2] == x.shape[1]
    with pytest.raises(ValueError, match="no cache"):
        tgemma.prefill(vlm, x.clone().requires_grad_(), mask, pos, tc.vlm, T32, kv_only=True)


# ---------------------------------------------------------------------------
# greedy decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 64])
def test_sample_actions_match(cfgs, jparams, tparams, batch, window):
    """Tokens equal (and their actions) for rows of different language
    length, with return_tokens, with the FAST decode window widened."""
    jc, tc = (dataclasses.replace(c, action_vocab_size=window) for c in cfgs)
    sample = jax.jit(lambda p, *a, return_tokens: jfast.sample_actions(
        p, jax.random.key(0), *a, cfg=jc, policy=J32, return_tokens=return_tokens), static_argnames="return_tokens")
    jin = [jnp.asarray(batch[k]) for k in INPUTS]
    tin = [torch.from_numpy(batch[k]) for k in INPUTS]
    jtok = np.asarray(sample(jparams, *jin, return_tokens=True))
    ttok = tfast.sample_actions(tparams, None, *tin, tc, T32, return_tokens=True)
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    assert ttok.dtype == torch.int32
    lo = tc.vlm.vocab_size - (window or tc.n_action_bins)
    assert ttok.min() >= lo and ttok.max() < tc.vlm.vocab_size
    actions = tfast.sample_actions(tparams, None, *tin, tc, T32)
    assert actions.shape == (2, tc.chunk_size, tc.max_action_dim) and actions.dtype == torch.float32
    np.testing.assert_array_equal(actions.numpy(), np.asarray(sample(jparams, *jin, return_tokens=False)))


def test_decode_cache_slots_and_positions(cfgs, tparams, batch):
    """Each step's K/V lands in slot P + s of every row, rotated at the row's
    own position prefix_count + s: the cache after a decode equals the one a
    full-sequence prefill of the generated tokens writes."""
    tc = cfgs[1]
    tin = [torch.from_numpy(batch[k]) for k in INPUTS]
    tokens = tfast.sample_actions(tparams, None, *tin, tc, T32, return_tokens=True)
    (ck, cv), pre_pad = tfast.prefix_cache(tparams, *tin, tc, T32)
    b, p_len = pre_pad.shape
    key_valid = torch.cat([pre_pad, pre_pad.new_zeros((b, tc.n_action_tokens))], dim=1)
    count = pre_pad.sum(dim=1, keepdim=True).to(torch.int32)
    x = tparams["action_start"].expand(b, 1, -1)
    for s in range(tc.n_action_tokens):
        key_valid[:, p_len + s] = True
        tfast.decode_token(tparams, x, (ck, cv), p_len + s, key_valid, count + s, tc, T32)
        x = tfast.embed_tokens(tparams, tokens[:, s:s + 1], tc, T32)
    embs, pad, att = tfast.embed_prefix(tparams, *tin, tc, T32)
    t = tc.n_action_tokens
    suf = torch.cat([tparams["action_start"].expand(b, 1, -1), tfast.embed_tokens(tparams, tokens[:, :-1], tc, T32)],
                    dim=1)
    pad = torch.cat([pad, pad.new_ones((b, t))], dim=1)
    att = torch.cat([att, att.new_ones((b, t))], dim=1)
    pos = torch.cumsum(pad.to(torch.int32), dim=1) - 1
    with torch.no_grad():
        _, (fk, fv) = tgemma.prefill(tparams["vlm"], torch.cat([embs, suf], dim=1), make_att_2d_masks(pad, att),
                                     pos, tc.vlm, T32, "xla")
    valid = pad  # padded prefix slots hold the plain path's values of never-read rows
    np.testing.assert_allclose(ck[:, valid].numpy(), fk[:, valid].numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cv[:, valid].numpy(), fv[:, valid].numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# host copies: the FAST tokenizer, the batched ManiSkill3 adapter
# ---------------------------------------------------------------------------

def test_fast_tokenizer_matches_reference(cfgs):
    from intact_tpu.models.pi0fast.fast_tokenizer import FastTokenizer as J
    from intact_tpu_torch.models.pi0fast.fast_tokenizer import FastTokenizer as T

    rng = np.random.default_rng(3)
    corpus = np.sin(np.linspace(0, 3, 8)[None, :, None] * rng.uniform(0.5, 2, (48, 1, 7))).astype(np.float32)
    j, t = J(scale=20.0, max_token=400).fit(corpus), T(scale=20.0, max_token=400).fit(corpus)
    assert t.merges == j.merges and len(t.merges) > 0
    for a in corpus[:4]:
        assert t.encode(a) == j.encode(a)
    ids_j, mask_j = j.encode_batch(corpus[:4], 40, vocab_size=257_152)
    ids_t, mask_t = t.encode_batch(corpus[:4], 40, vocab_size=257_152)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_array_equal(t.decode_batch(ids_t, mask_t, 8, 7, 257_152), j.decode_batch(ids_j, mask_j, 8, 7,
                                                                                            257_152))
    np.testing.assert_array_equal(t.decode([0, 99999, 3], 8, 7), j.decode([0, 99999, 3], 8, 7))


def test_batch_adapter_matches_reference():
    from intact_tpu.config.pipeline import EnvConfig as JEnv
    from intact_tpu.envs.adapters.simplerMS3 import BatchBridgeSimplerAdapter as J
    from intact_tpu_torch.config.pipeline import EnvConfig as TEnv
    from intact_tpu_torch.envs.adapters.simplerMS3 import BatchBridgeSimplerAdapter as T

    rng = np.random.default_rng(5)
    quat = rng.standard_normal((3, 4))
    obs = {"observation.images.top": rng.integers(0, 256, (3, 64, 48, 3), dtype=np.uint8),
           "observation.state": np.concatenate([rng.uniform(-0.3, 0.3, (3, 3)),
                                                quat / np.linalg.norm(quat, axis=1, keepdims=True),
                                                rng.uniform(0, 1, (3, 1))], axis=1),
           "task": ["put the spoon on the towel"] * 3}
    for norm in ("bound", "gaussian"):
        kw = dict(dataset_statistics_path=STATS, image_size=(28, 28), action_normalization_type=norm,
                  state_normalization_type=norm)
        j = J(types.SimpleNamespace(env=JEnv(**kw), seed=0))
        t = T(types.SimpleNamespace(env=TEnv(**kw), seed=0))
        for uint8 in (False, True):
            j.output_uint8 = t.output_uint8 = uint8
            pj, pt = j.preprocess(obs), t.preprocess(obs)
            assert pt["task"] == pj["task"]
            for key in ("image", "state"):
                assert pt[key].dtype == pj[key].dtype
            np.testing.assert_array_equal(pt["state"], pj["state"])
            if uint8:
                np.testing.assert_array_equal(pt["image"], pj["image"])
            else:  # the reference's native normalize fuses x * s + o; the port is its numpy fallback
                np.testing.assert_allclose(pt["image"], pj["image"], rtol=0, atol=2.0**-23)
        actions = rng.uniform(-1, 1, (3, 4, 7)).astype(np.float32)
        np.testing.assert_array_equal(t.postprocess_batch(actions), j.postprocess_batch(actions))


# ---------------------------------------------------------------------------
# configs, the trainer, the serving wrapper
# ---------------------------------------------------------------------------

def port_config(path: Path, **overrides):
    from intact_tpu_torch import run

    argv = ["--config_path", str(path)]
    for k, v in overrides.items():
        argv += [f"--{k}", str(v)]
    return run.build_config(argv)[0]


@pytest.mark.parametrize("path", [TRAIN_YAML, EV_YAML], ids=["train", "ev"])
def test_model_config_from_yaml_matches_reference(path):
    from intact_tpu.config import TrainPipelineConfig as JP
    from intact_tpu.config import from_dict as j_from_dict
    from intact_tpu.config import load_yaml as j_load_yaml

    ref = j_from_dict(JP, j_load_yaml(str(path))).make_model_config()
    cfg = port_config(path).make_model_config()
    assert isinstance(cfg, TCfg) and dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert (cfg.max_state_dim, cfg.max_action_dim, cfg.n_action_bins) == (32, 7, 256)


def test_unported_model_types_raise():
    with pytest.raises(NotImplementedError, match="the other model families"):
        port_config(TRAIN_YAML, **{"model_cfg.type": "magma"}).make_model_config()  # the HF scaffold


def test_trainer_runs_the_recipe_and_its_first_loss_matches(cfgs, jparams, tmp_path, caplog):
    """pi0fast_finetune_bridge.yaml at pi0fast_tiny (fp32, one card, micro 2 x
    accumulation 2, 2 updates, remat): the first micro-step's loss equals the
    JAX compute_loss on the same params and batch; every micro-step's
    metrics are finite, the tied table trains and the last update is saved."""
    from intact_tpu_torch.train import checkpoint as ckpt
    from intact_tpu_torch.train.trainer import Trainer

    cfg = port_config(TRAIN_YAML, **{"model_cfg.type": "pi0fast_tiny", "mesh.fsdp": 1, "per_device_batch_size": 2,
                                     "global_batch_size": 4, "n_updates": 2, "log_freq": 1, "use_bf16": "false",
                                     "tokenizer_path": "hash", "log_dir": tmp_path, "eval_freq": 2,
                                     "eval_size": 2})
    assert cfg.remat and not cfg.fused_update and cfg.master_dtype == "float32"
    trainer = Trainer(cfg, device="cpu")
    assert trainer.frozen_mask is None  # freeze_lm_head leaves the tied table trainable
    src = tcm.flatten_paths(convert.from_jax_params(jax.tree.map(np.asarray, jparams), cfgs[1], device="cpu"))
    for k, v in tcm.flatten_paths(trainer.state.params).items():
        v.copy_(src[k])
    seen = []
    real = trainer.train_step

    def recorded(state, batch):
        if not seen:
            seen.append({k: v.numpy().copy() for k, v in batch.items()})
        state, m = real(state, batch)
        seen.append(m)
        return state, m

    trainer.train_step = recorded
    with caplog.at_level(logging.INFO, logger="intact_tpu_torch.trainer"):
        trainer.train()
    first, metrics = seen[0], seen[1:]
    jl, jaux = jax_loss(cfgs[0])(jparams, jax_batch(first))
    assert abs(metrics[0]["l2_loss"].item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert metrics[0]["token_accuracy"].item() == float(jaux["token_accuracy"])
    assert len(metrics) == 4 and all(np.isfinite(m[k].item()) for m in metrics for k in ("l2_loss", "grad_norm"))
    assert not torch.equal(tcm.flatten_paths(trainer.state.params)["vlm_embed/embedding"], src["vlm_embed/embedding"])
    assert "token_accuracy" in caplog.text and "val @ update 2" in caplog.text
    assert ckpt.list_steps(trainer.ckpt_root, committed_only=True) == [2]


def test_wrapper_serves_pi0fast_tiny(monkeypatch):
    """The server role's Pi0PolicyWrapper for pi0fast_tiny (7 action dims, as
    the bridge's env actions) on the simplerMS3 yaml: fused multi-row
    requests through infer_batch equal the JAX sample_actions on the same
    weights, through the batched adapter's postprocess."""
    from intact_tpu_torch.models import registry
    from intact_tpu_torch.serve.policy_wrapper import Pi0PolicyWrapper, make_policy_wrapper

    tiny7 = dataclasses.replace(TCfg.tiny(), max_action_dim=7)
    monkeypatch.setitem(registry.get("pi0fast_tiny"), "default_config", lambda: tiny7)
    cfg = port_config(EV_YAML, **{"model_cfg.type": "pi0fast_tiny", "eval_cfg.pretrained_model_path": "null",
                                  "tokenizer_path": "hash", "use_bf16": "false", "env.image_size": "[28, 28]"})
    wrapper = make_policy_wrapper(cfg, device="cpu")
    assert type(wrapper) is Pi0PolicyWrapper and wrapper.policy.model is tfast
    rng = np.random.default_rng(2)
    tasks = ["put carrot on plate", "stack the green block on the yellow block", "put the spoon on the towel"]
    reqs = [{"image": rng.integers(0, 256, (n, 28, 28, 3), dtype=np.uint8),
             "state": rng.uniform(-1, 1, (n, 7)).astype(np.float32), "task": tasks[:n]} for n in (2, 1)]
    sessions = [wrapper.new_session() for _ in reqs]
    out = wrapper.infer_batch(list(zip(reqs, sessions)))
    assert [o.shape for o in out] == [(2, tiny7.chunk_size, 7), (1, tiny7.chunk_size, 7)]

    policy = wrapper.policy
    merged = {"image": np.concatenate([r["image"] for r in reqs]), "state": np.concatenate([r["state"] for r in reqs]),
              "task": tasks[:2] + tasks[:1]}
    inputs = [jnp.asarray(x.numpy()) for x in policy.device_inputs(merged)]
    jcfg = dataclasses.replace(JCfg.tiny(), max_action_dim=7)
    ref = np.asarray(jfast.sample_actions(tcm.tree_map(lambda t: jnp.asarray(t.numpy()), policy.params),
                                          jax.random.key(0), *inputs, jcfg, J32))
    ref = sessions[0].adapter.postprocess_batch(ref[:, :cfg.eval_cfg.action_step])
    np.testing.assert_array_equal(np.concatenate(out), ref)
