"""The PyTorch port's native Magma against the JAX package's, on the CPU.

`MagmaConfig.tiny()` (ConvNeXt with 2 stages of 2 blocks, LLaMA with 2
layers, 4 query heads over 2 KV heads, an untied 512-row head) on
parameters made by the JAX `init` and carried across by
`convert.from_jax_params`; inputs from seeded numpy generators, prompts of
two tasks of different lengths (right padding: the last valid index and
the positions differ per row). The JAX side runs compiled (`jax.jit`), as
the reference serves. Both sides run in fp32 unless a test says otherwise.
No test opens a socket. Tolerances, each with its reason:
  * ConvNeXt features and pooled output, hidden states, K/V caches, the
    projected vision tokens and the spliced embeddings 1e-5 (absolute and
    relative): the same fp32 ops, products and convolutions summed in
    another order;
  * logits 1e-4: the hidden states' 1e-5 through the 512-row head;
  * tokens, and so the actions, equal: greedy decoding is discontinuous,
    and a tie within the tiny model's fp32 rounding would flip a token (none
    is near one on these inputs);
  * the int8 lm_head and down products bit-equal to `jax.jit(cm._dense_int8)`:
    the port reproduces the compiled reference's fp32 steps;
  * `normalize_images` bit-equal to the op-by-op reference (the port's
    operations) and within 3e-7 of the compiled one (XLA fuses the
    `/ 255 - mean` into a multiply-add);
  * the prompt and the HF import equal (integer ids; a permutation of the
    same values).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intact_tpu.models import common as jcm
from intact_tpu.models import convnext as jconvnext
from intact_tpu.models import llama as jllama
from intact_tpu.models.magma import model as jmagma
from intact_tpu.models.magma.config import MagmaConfig as JCfg
from intact_tpu.models.tokenizer import HashTokenizer as JTok
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models import convnext as tconvnext
from intact_tpu_torch.models import llama as tllama
from intact_tpu_torch.models.magma import model as tmagma
from intact_tpu_torch.models.magma.config import MagmaConfig as TCfg
from intact_tpu_torch.models.tokenizer import HashTokenizer as TTok
from tests.test_magma_native import _fake_magma_sd, _lm_to_hf, _vision_to_timm
from tests.test_torch_spatialvla import STATS

J32 = jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
T32 = tcm.FP32_POLICY
TOL = dict(rtol=1e-5, atol=1e-5)
TASKS = ["put carrot on plate", "stack the green block on the yellow block"]


def t_(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def cfgs():
    return JCfg.tiny(), TCfg.tiny()


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jax.tree.map(np.asarray, jax.jit(jmagma.init, static_argnums=1)(jax.random.key(0), cfgs[0]))


@pytest.fixture(scope="module")
def tparams(cfgs, jparams):
    return convert.from_jax_params(jparams, cfgs[1], device="cpu")


@pytest.fixture(scope="module")
def jq(jparams):
    return jax.tree.map(np.asarray, jax.jit(jcm.quantize_params)(jparams))


def prompt(cfg, tasks=TASKS):
    """The wrapper's prompt: the hash tokenizer bounded below image_token_id."""
    return tmagma.build_prompt(TTok(vocab_size=cfg.image_token_id, max_length=cfg.max_prompt_tokens), tasks, cfg)


@pytest.fixture(scope="module")
def batch(cfgs):
    tc = cfgs[1]
    tokens, masks = prompt(tc)
    assert masks.sum(axis=1)[0] != masks.sum(axis=1)[1]  # ragged rows
    s = tc.image_size
    images = np.random.default_rng(1).normal(size=(2, s, s, 3)).astype(np.float32)
    return images, tokens, masks


def jax_generate(jc, params, batch, policy=J32):
    return np.asarray(jax.jit(lambda p, *a: jmagma.generate(p, *a, jc, policy))(params, *batch))


def test_bridge_fills_every_parameter(jparams, tparams):
    src, out = tcm.flatten_paths(jparams), tcm.flatten_paths(tparams)
    assert src.keys() == out.keys() and len(out) > 40
    for k, v in src.items():
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


def test_convnext_encode_matches(cfgs, jparams, tparams, batch):
    jc, tc = cfgs
    jf, jpool = jax.jit(lambda p, x: jconvnext.encode(p, x, jc.vision, J32))(jparams["vision"], batch[0])
    tf, tpool = tconvnext.encode(tparams["vision"], t_(batch[0]), tc.vision, T32)
    assert tf.shape == (2, 4, 4, tc.vision.dims[-1]) and tpool.shape == (2, tc.vision.dims[-1])
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), **TOL)


def lm_prompt(cfg, b=2, p=7, seed=3):
    """Random prompt embeddings, row 1 right-padded by 2."""
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((b, p, cfg.width)).astype(np.float32)
    mask = np.ones((b, p), bool)
    mask[1, -2:] = False
    return embeds, mask


def test_llama_forward_and_logits_match(cfgs, jparams, tparams):
    """Hidden states, the K/V cache and the untied head's logits, causal over
    7 tokens with one row right-padded."""
    jc, tc = cfgs[0].lm, cfgs[1].lm
    embeds, pmask = lm_prompt(tc)
    p = embeds.shape[1]
    mask = np.tril(np.ones((p, p), bool))[None] & pmask[:, None, :]
    pos = (np.cumsum(pmask, axis=1) - 1).astype(np.int32)
    jh, (jk, jv) = jax.jit(lambda prm, e, m, q: jllama.forward(prm, e, m, q, jc, J32))(jparams["lm"], embeds, mask, pos)
    th, (tk, tv) = tllama.forward(tparams["lm"], t_(embeds), t_(mask), t_(pos), tc, T32)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    jl = jax.jit(lambda prm, h: jllama.logits(prm, h, jc, J32))(jparams["lm"], np.asarray(jh))
    tl = tllama.logits(tparams["lm"], th, tc, T32)
    assert tl.dtype == torch.float32 and tl.shape == (2, p, tc.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


def test_llama_greedy_decode_matches(cfgs, jparams, tparams):
    """Tokens of the KV-cached decode equal the reference's; each step's logits
    with the reference's tokens fed back (teacher forcing, through prefill and
    decode_step) equal the reference's uncached forward over prompt + tokens
    at the decode positions (last valid + 1 + i), within 1e-4."""
    jc, tc = cfgs[0].lm, cfgs[1].lm
    embeds, pmask = lm_prompt(tc, seed=4)
    n = 6
    ref = np.asarray(jax.jit(lambda prm, e, m: jllama.greedy_decode(prm, e, m, n, jc, J32))(jparams["lm"], embeds,
                                                                                              pmask))
    out = tllama.greedy_decode(tparams["lm"], t_(embeds), t_(pmask), n, tc, T32)
    assert out.shape == (2, n)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(np.unique(ref)) > 2

    # the reference, uncached: prompt + the fed-back tokens in one causal pass
    b, p = pmask.shape
    fed = np.asarray(jcm.embed_lookup(jparams["lm"]["embed"], ref[:, :-1], J32))
    full = np.concatenate([embeds, fed], axis=1)
    valid = np.concatenate([pmask, np.ones((b, n - 1), bool)], axis=1)
    last = pmask.sum(axis=1) - 1
    pos = np.concatenate([np.cumsum(pmask, axis=1) - 1, last[:, None] + 1 + np.arange(n - 1)], axis=1)
    mask = np.tril(np.ones((p + n - 1, p + n - 1), bool))[None] & valid[:, None, :]
    jh, _ = jax.jit(lambda prm, e, m, q: jllama.forward(prm, e, m, q, jc, J32))(jparams["lm"], full, mask,
                                                                               pos.astype(np.int32))
    rows = np.arange(b)[:, None]
    at = np.concatenate([last[:, None], p + np.arange(n - 1)[None].repeat(b, 0)], axis=1)
    want = np.asarray(jllama.logits(jparams["lm"], np.asarray(jh)[rows, at], jc, J32))  # [B, n, V]

    with torch.inference_mode():
        h, cache, key_valid, nxt = tllama.prefill(tparams["lm"], t_(embeds), t_(pmask), n, tc, T32)
        got = [tllama.logits(tparams["lm"], h, tc, T32)]
        for s in range(n - 1):
            h = tllama.decode_step(tparams["lm"], t_(ref[:, s]), cache, p + s, key_valid, nxt + s, tc, T32)
            got.append(tllama.logits(tparams["lm"], h, tc, T32))
    np.testing.assert_array_equal(nxt.numpy(), last + 1)
    np.testing.assert_allclose(torch.stack(got, dim=1).numpy(), want, rtol=1e-4, atol=1e-4)


def test_prompt_embedding_matches(cfgs, jparams, tparams, batch):
    """normalize_images, encode_images and embed_prompt; the i-th placeholder
    of a row carries that row's i-th vision token, the text its embedding."""
    jc, tc = cfgs
    u8 = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    norm = tmagma.normalize_images(t_(u8)).numpy()
    np.testing.assert_array_equal(norm, np.asarray(jmagma.normalize_images(u8)))
    np.testing.assert_allclose(norm, np.asarray(jax.jit(jmagma.normalize_images)(u8)), rtol=0, atol=3e-7)
    images, tokens, masks = batch
    jv = jax.jit(lambda p, x: jmagma.encode_images(p, x, jc, J32))(jparams, images)
    tv = tmagma.encode_images(tparams, t_(images), tc, T32)
    assert tv.shape == (2, tc.n_image_tokens, tc.lm.width)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    je, jm = jax.jit(lambda p, *a: jmagma.embed_prompt(p, *a, jc, J32))(jparams, *batch)
    te, tm = tmagma.embed_prompt(tparams, *(t_(x) for x in batch), tc, T32)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    is_img = tokens == tc.image_token_id
    assert (is_img.sum(axis=1) == tc.n_image_tokens).all()
    for r in range(2):
        np.testing.assert_array_equal(te[r][t_(is_img[r])].numpy(), tv[r].numpy())
    text = tcm.embed_lookup(tparams["lm"]["embed"], t_(tokens), T32)
    np.testing.assert_array_equal(te[t_(~is_img)].numpy(), text[t_(~is_img)].numpy())


def colliding_word(vocab: int, target: int) -> str:
    """A word the hash tokenizer of `vocab` ids maps onto `target`."""
    tok = TTok(vocab_size=vocab)
    return next(w for w in (f"w{i}" for i in range(100_000)) if tok._word_id(w) == target)


@pytest.mark.parametrize("chat", [False, True])
@pytest.mark.parametrize("case", ["plain", "truncated", "collision"])
def test_build_prompt_matches(cfgs, chat, case):
    """The prompt ids and mask equal the reference's: with the chat template
    on and off, an instruction past max_prompt_tokens (the chat suffix
    kept), and a text token equal to image_token_id (remapped)."""
    jc, tc = (dataclasses.replace(c, use_chat_template=chat) for c in cfgs)
    vocab = jc.image_token_id
    tasks = list(TASKS)
    if case == "truncated":
        tasks[1] = " ".join(["word"] * 3 * jc.max_prompt_tokens)
    if case == "collision":
        vocab = jc.lm.vocab_size  # an unbounded tokenizer can hit the placeholder
        tasks[0] = "put " + colliding_word(vocab, jc.image_token_id)
    jt, tt = JTok(vocab_size=vocab, max_length=jc.max_prompt_tokens), TTok(vocab_size=vocab,
                                                                           max_length=jc.max_prompt_tokens)
    jtok, jmask = jmagma.build_prompt(jt, tasks, jc)
    ttok, tmask = tmagma.build_prompt(tt, tasks, tc)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(tmask, jmask)
    assert ttok.dtype == np.int32 and tmask.dtype == bool
    n_img = (ttok == tc.image_token_id).sum(axis=1)
    assert (n_img == tc.n_image_tokens).all()  # a collision never adds a placeholder
    if case == "truncated":
        assert tmask[1].all()
        if chat:
            suffix = tmagma._encode_segment(tt, tmagma._CHAT_POST)
            np.testing.assert_array_equal(ttok[1][-len(suffix):], suffix)


def test_generate_matches(cfgs, jparams, tparams, batch):
    jc, tc = cfgs
    ref = jax_generate(jc, jparams, batch)
    out = tmagma.generate(tparams, *(t_(x) for x in batch), tc, T32)
    assert out.shape == (2, tc.n_action_tokens + 1)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(np.unique(ref)) > 2


def test_int8_tree_tokens_and_products_match(cfgs, jparams, jq, batch):
    """The int8 serving tree (jax.jit(quantize_params), carried across):
    every LLaMA block kernel and the untied lm_head int8 (K-major), the
    `lm/embed` rows int8, the vision tower and projector fp; the tokens
    equal jax.jit(generate)'s; the lm_head and a down product bit-equal to
    jax.jit(cm._dense_int8), in fp32 and in bf16 compute."""
    jc, tc = cfgs
    tq = convert.from_jax_params(jq, tc, device="cpu")
    flat = tcm.flatten_paths(tq)
    assert flat["lm/lm_head/kernel_q"].shape == (tc.lm.vocab_size, tc.lm.width)
    np.testing.assert_array_equal(flat["lm/lm_head/kernel_q"].numpy(), jq["lm"]["lm_head"]["kernel_q"].T)
    assert flat["lm/embed/embedding_q"].dtype == torch.int8 and "lm/blocks/mlp/down/kernel_q" in flat
    assert "vision/stage_0/pw1/kernel" in flat and "projector/linear_1/kernel" in flat
    port_q = tcm.flatten_paths(tcm.quantize_params(convert.from_jax_params(jparams, tc, device="cpu")))
    assert port_q.keys() == flat.keys()

    ref = jax_generate(jc, jq, batch)
    out = tmagma.generate(tq, *(t_(x) for x in batch), tc, T32)
    np.testing.assert_array_equal(out.numpy(), ref)

    rng = np.random.default_rng(6)
    for jpol, tpol in ((J32, T32), (jcm.SERVING_POLICY, tcm.SERVING_POLICY)):
        for name, k in (("lm_head", tc.lm.width), ("down", tc.lm.mlp_dim)):
            x = rng.standard_normal((3, 2, k)).astype(np.float32)
            x[0, 0] = 0.0  # an all-zero row: the activation scale's floor
            if name == "lm_head":
                jp, tp = jq["lm"]["lm_head"], tq["lm"]["lm_head"]
            else:
                jp = jax.tree.map(lambda a: a[1], jq["lm"]["blocks"]["mlp"]["down"])
                tp = tcm.layer(tq["lm"]["blocks"], 1)["mlp"]["down"]
            xj = jnp.asarray(x, jpol.compute_dtype)
            want = np.asarray(jax.jit(lambda p, v: jcm._dense_int8(p, v, jpol))(jp, xj).astype(jnp.float32))
            got = tcm._dense_int8(tp, t_(np.asarray(xj.astype(jnp.float32))).to(tpol.compute_dtype), tpol)
            assert got.dtype == tpol.compute_dtype
            np.testing.assert_array_equal(got.float().numpy(), want, err_msg=f"{name} {tpol.compute_dtype}")


# ---------------------------------------------------------------------------
# the HF importer
# ---------------------------------------------------------------------------

def assert_tree_equal(tree, params):
    got = tcm.flatten_paths(tree)
    want = tcm.flatten_paths(params)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(v, np.float32), err_msg=k)


def write_snapshot(sd: dict, path):
    """Two safetensors shards and their index, as HF snapshots are laid out."""
    from safetensors.numpy import save_file

    sd = {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}
    names = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": names[::2], "model-00002-of-00002.safetensors": names[1::2]}
    path.mkdir(parents=True, exist_ok=True)
    for fname, keys in shards.items():
        save_file({k: sd[k] for k in keys}, str(path / fname))
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: f for f, keys in shards.items() for k in keys}}))
    return sd


def test_hf_snapshot_loads_as_the_reference(cfgs, jparams, tmp_path):
    """A sharded snapshot of the timm/HF layout: load_magma_checkpoint gives
    the reference loader's tree, leaf for leaf, and the source weights."""
    jc, tc = cfgs
    write_snapshot(_fake_magma_sd(jparams, jc), tmp_path)
    out = tmagma.load_magma_checkpoint(str(tmp_path), tc)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in tcm.tree_leaves(out))
    assert_tree_equal(out, jmagma.load_magma_checkpoint(str(tmp_path), jc))
    assert_tree_equal(out, jparams)


def alternate_layout(params, cfg):
    """vision_tower.trunk.* (no clip_vision_model) and the Sequential-style
    projector (proj.0 / proj.2)."""
    sd = _vision_to_timm(params["vision"], cfg, "vision_tower.trunk")
    sd.update(_lm_to_hf(params["lm"], cfg, "language_model"))
    pj = params["projector"]
    for i, name in ((0, "linear_1"), (2, "linear_2")):
        sd[f"multi_modal_projector.proj.{i}.weight"] = np.asarray(pj[name]["kernel"]).T
        sd[f"multi_modal_projector.proj.{i}.bias"] = np.asarray(pj[name]["bias"])
    return sd


def padded_vocab(params, cfg, pad=16):
    sd = _fake_magma_sd(params, cfg)
    for key in ("language_model.model.embed_tokens.weight", "language_model.lm_head.weight"):
        sd[key] = np.concatenate([sd[key], np.zeros((pad, sd[key].shape[1]), sd[key].dtype)])
    return sd


def no_head_norm(params, cfg):
    sd = _fake_magma_sd(params, cfg)
    for field in ("weight", "bias"):
        del sd[f"vision_tower.clip_vision_model.trunk.head.norm.{field}"]
    return sd


@pytest.mark.parametrize("layout", [alternate_layout, padded_vocab, no_head_norm], ids=lambda f: f.__name__)
def test_hf_import_variants_match_reference(cfgs, jparams, layout):
    """The alternate prefixes, vocabulary tables padded past the
    configuration (sliced), and a checkpoint without the pooling head's norm
    (an identity norm): the reference importer's tree each time."""
    jc, tc = cfgs
    sd = layout(jparams, jc)
    out = tmagma.from_hf_state_dict(sd, tc)
    assert_tree_equal(out, jmagma.from_hf_state_dict(sd, jc))
    if layout is no_head_norm:
        np.testing.assert_array_equal(out["vision"]["final_ln"]["scale"].numpy(), np.ones(tc.vision.dims[-1]))
    else:
        assert_tree_equal(out, jparams)


def test_hf_import_refuses_drift(cfgs, jparams):
    """An unknown key under the vision prefix and a wrongly shaped leaf raise."""
    jc, tc = cfgs
    sd = _fake_magma_sd(jparams, jc)
    sd["vision_tower.clip_vision_model.trunk.mystery.weight"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unrecognized"):
        tmagma.from_hf_state_dict(sd, tc)
    sd = _fake_magma_sd(jparams, jc)
    sd["multi_modal_projector.linear_1.weight"] = np.zeros((3, 5), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        tmagma.from_hf_state_dict(sd, tc)


# ---------------------------------------------------------------------------
# the wrapper through infer_batch
# ---------------------------------------------------------------------------

def pipeline_configs():
    """(the reference's, the port's) pipeline config of the JAX package's own
    serving test: magma_native_tiny on the Bridge adapter, fp32 params and
    bf16 compute (use_bf16 false), action_step 1."""
    from intact_tpu.config import pipeline as jp
    from intact_tpu_torch.config import pipeline as tp

    return [mod.TrainPipelineConfig(
        name="magma_native_serve_test", model_cfg={"type": "magma_native_tiny"}, use_bf16=False,
        tokenizer_path="hash",
        eval_cfg=mod.EvalConfig(simulator_name="simpler", env_adapter="BridgeSimplerAdapter",
                                task_list=["widowx_carrot_on_plate"], n_eval_episode=1, n_video=0, recording=False,
                                role="server", host="127.0.0.1", port=0, action_step=1),
        env=mod.EnvConfig(dataset_statistics_path=STATS, image_size=(32, 32))) for mod in (jp, tp)]


@pytest.fixture(scope="module")
def wrappers(cfgs, jparams, tmp_path_factory):
    """The JAX package's wrapper and the port's (type from the registry), both
    loading one HF snapshot of the JAX init's weights
    (eval_cfg.pretrained_model_path), both computing in fp32 (the wrappers'
    use_bf16 false means bf16 compute, where XLA's and torch's roundings may
    flip a greedy token of the tiny random model)."""
    from intact_tpu.serve.policy_wrapper import MagmaNativePolicyWrapper as JW
    from intact_tpu_torch.serve.policy_wrapper import MagmaNativePolicyWrapper, make_policy_wrapper

    snap = tmp_path_factory.mktemp("magma_snapshot")
    write_snapshot(_fake_magma_sd(jparams, cfgs[0]), snap)
    jcfg, tcfg = pipeline_configs()
    jcfg.eval_cfg.pretrained_model_path = tcfg.eval_cfg.pretrained_model_path = str(snap)
    jw = JW(jcfg)
    tw = make_policy_wrapper(tcfg, device="cpu")
    assert type(tw) is MagmaNativePolicyWrapper and not tw.quantize and tw.policy == tcm.DEFAULT_POLICY
    assert_tree_equal(tw.params, jparams)
    cfg = jw.model_cfg
    jw._generate = jax.jit(lambda p, u8, t, m: jmagma.generate(p, jmagma.normalize_images(u8), t, m, cfg, J32))
    tw.policy = T32
    return jw, tw


def test_wrapper_infer_batch_matches_reference(wrappers):
    """Three sessions fused into one call (bucket 4): each env action equals
    the JAX wrapper's `_infer_fused` on the same requests; the token ids lie
    in the vocabulary; a two-row request is refused by the session."""
    jw, tw = wrappers
    s = tw.model_cfg.image_size
    rng = np.random.default_rng(10)
    tasks = ["put carrot on plate", "stack the green block on the yellow block", "put the spoon on the towel"]
    reqs = [{"image": rng.integers(0, 256, (1, s, s, 3), dtype=np.uint8), "task": [t]} for t in tasks]
    jsess, tsess = [jw.new_session() for _ in tasks], [tw.new_session() for _ in tasks]
    out = tw.infer_batch(list(zip(reqs, tsess)))
    ref = jw._infer_fused(list(zip(reqs, jsess)))
    assert [o.shape for o in out] == [(1, 7)] * 3
    for o, r in zip(out, ref):
        assert np.isfinite(o).all()
        np.testing.assert_allclose(o, r, rtol=1e-6, atol=1e-6)
    ids = tw.generate_tokens(np.concatenate([r["image"] for r in reqs]), tasks)
    assert ids.shape == (3, tw.model_cfg.n_action_tokens + 1)
    assert ids.min() >= 0 and ids.max() < tw.model_cfg.lm.vocab_size
    two_rows = tw.new_session()
    two_rows.adapter.preprocess = lambda obs: {"image": np.zeros((2, s, s, 3), np.uint8), "task": ["a", "b"]}
    with pytest.raises(ValueError, match="single-env"):
        two_rows.preprocess({})


def test_wrapper_loads_checkpoints(cfgs, jparams, tmp_path):
    """switch_model in int8: an HF snapshot directory lands quantized as the
    JAX wrapper's checkpoint path quantizes it (jcm.quantize_host_tree,
    bit-equal); the model generation counts the swap."""
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    jc, tc = cfgs
    _, tcfg = pipeline_configs()
    tcfg.eval_cfg.quantize_int8 = True
    w = make_policy_wrapper(tcfg, device="cpu")
    assert w.quantize and w.params["lm"]["lm_head"]["kernel_q"].dtype == torch.int8
    sd = write_snapshot(_fake_magma_sd(jparams, jc), tmp_path)
    w.switch_model(str(tmp_path))
    want = jcm.quantize_host_tree(jmagma.from_hf_state_dict(sd, jc), jcm.DEFAULT_POLICY)
    want = tcm.flatten_paths(convert.from_jax_params(jax.tree.map(np.asarray, want), tc, device="cpu"))
    got = tcm.flatten_paths(w.params)
    assert got.keys() == want.keys() and w.model_generation == 1
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_registry_types_and_unported_scaffold(cfgs):
    from intact_tpu_torch.models import registry
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    _, tcfg = pipeline_configs()
    assert tcfg.make_model_config() == cfgs[1]
    tcfg.model_cfg = {"type": "magma_native"}
    assert tcfg.make_model_config() == TCfg.magma_8b()
    assert registry.module("magma_native") is tmagma
    tcfg.model_cfg = {"type": "magma"}  # the HF-scaffold wrapper: it raises without the upstream asset
    with pytest.raises(RuntimeError, match="magma_native"):
        make_policy_wrapper(tcfg, device="cpu")


def test_full_width_shapes_on_meta():
    """Magma-8B on the meta device: every leaf's shape equals the reference
    init's (jax.eval_shape), ~8.9 B parameters, and the int8 tree's codes
    K-major for the W8A8 kernel (the untied lm_head 128,256 x 4096)."""
    cfg = TCfg.magma_8b()
    params = tmagma.init(cfg, device="meta")
    want = jax.eval_shape(lambda k: jmagma.init(k, JCfg.magma_8b()), jax.random.key(0))
    got = tcm.flatten_paths(params)
    want = tcm.flatten_paths(want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    n = sum(x.numel() for x in tcm.tree_leaves(params))
    print(f"Magma-8B: {n / 1e9:.3f} B parameters, {cfg.n_image_tokens} image tokens")
    assert 8.8e9 < n < 9.0e9 and cfg.n_image_tokens == 256
    q = tcm.quantize_params(params)
    assert q["lm"]["lm_head"]["kernel_q"].shape == (128_256, 4096)
    assert q["lm"]["blocks"]["mlp"]["down"]["kernel_q"].shape == (32, 4096, 14_336)
    assert "kernel" in q["vision"]["stage_2"]["pw1"] and "kernel" in q["projector"]["linear_1"]
