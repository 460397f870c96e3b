"""The PyTorch port's native SpatialVLA against the JAX package's, on the CPU.

`SpatialVLAConfig.tiny()` (a 2x2 patch grid, Gemma2 with 2 layers, a
sliding window of 3 keys) on parameters made by the JAX `init` and carried
across by `convert.from_jax_params`; inputs from seeded numpy generators,
with ragged language padding. The JAX side runs compiled (`jax.jit`), as
the reference serves. Both sides run in fp32 unless a test says otherwise.
Tolerances, each with its reason:
  * hidden states, K/V caches, the Ego3D encoding and the prefix
    embeddings 1e-5 (absolute and relative): the same fp32 ops, products
    summed in another order;
  * tokens, and so the actions, equal: greedy decoding is discontinuous,
    and a tie within the tiny model's fp32 rounding would flip a token (none
    is near one on these inputs);
  * the int8 unembedding bit-equal to `jax.jit(cm.unembed_logits)`: the
    port reproduces the compiled reference's fp32 steps; the softcapped
    logits on top within 1e-6: XLA's and torch's fp32 tanh differ in the
    last bits;
  * the action tokenizer and the ensembler equal (copies of the reference's
    numpy code); the HF import equal (a permutation of the same values).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intact_tpu.models import common as jcm
from intact_tpu.models import gemma2 as jgemma2
from intact_tpu.models.spatialvla import model as jsvla
from intact_tpu.models.spatialvla.config import SpatialVLAConfig as JCfg
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models import gemma2 as tgemma2
from intact_tpu_torch.models.spatialvla import model as tsvla
from intact_tpu_torch.models.spatialvla.config import SpatialVLAConfig as TCfg

REPO = Path(__file__).resolve().parent.parent
EV_YAML = REPO / "config/experiment/simpler/spatialvla_finetune_bridge_ev.yaml"
STATS = str(REPO / "config/dataset/bridge_statistics.json")
J32 = jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
T32 = tcm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-5)


def t_(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def cfgs():
    return JCfg.tiny(), TCfg.tiny()


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jax.tree.map(np.asarray, jax.jit(jsvla.init, static_argnums=1)(jax.random.key(0), cfgs[0]))


@pytest.fixture(scope="module")
def tparams(cfgs, jparams):
    return convert.from_jax_params(jparams, cfgs[1], device="cpu")


@pytest.fixture(scope="module")
def batch(cfgs):
    cfg = cfgs[0]
    rng = np.random.default_rng(1)
    b, s, g = 2, cfg.vision.image_size, cfg.vision.grid
    lang_masks = np.zeros((b, cfg.tokenizer_max_length), bool)
    lang_masks[0, :6] = True
    lang_masks[1, :3] = True  # ragged language padding: the last valid prompt token differs per row
    return {
        "images": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "depth": rng.uniform(0.5, 2.0, (b, g, g)).astype(np.float32),
        "lang_tokens": rng.integers(0, cfg.spatial_offset, (b, cfg.tokenizer_max_length)).astype(np.int32),
        "lang_masks": lang_masks,
    }


INPUTS = ("images", "depth", "lang_tokens", "lang_masks")


def jax_tokens(jc, params, batch, policy=J32):
    fn = jax.jit(lambda p, *a: jsvla.predict_action_tokens(p, *a, jc, policy))
    return np.asarray(fn(params, *(batch[k] for k in INPUTS)))


def test_bridge_fills_every_parameter(jparams, tparams):
    src, out = tcm.flatten_paths(jparams), tcm.flatten_paths(tparams)
    assert src.keys() == out.keys() and len(out) > 30
    for k, v in src.items():
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


def test_quantized_tree_carries_across(cfgs, jparams):
    """jax.jit(quantize_params): the block kernels and img_proj int8
    (K-major), the tied `lm/embed` table int8 rows with fp32 row scales as
    they are, the Ego3D MLP fp; the same node set as the port's own
    quantize_params."""
    jq = jax.tree.map(np.asarray, jax.jit(jcm.quantize_params)(jparams))
    tq = convert.from_jax_params(jq, cfgs[1], device="cpu")
    flat = tcm.flatten_paths(tq)
    assert flat["lm/embed/embedding_q"].dtype == torch.int8 and flat["lm/embed/embed_scale"].dtype == torch.float32
    np.testing.assert_array_equal(flat["lm/embed/embedding_q"].numpy(), jq["lm"]["embed"]["embedding_q"])
    np.testing.assert_array_equal(flat["lm/blocks/mlp/down/kernel_q"].numpy(),
                                  np.swapaxes(jq["lm"]["blocks"]["mlp"]["down"]["kernel_q"], -1, -2))
    assert "ego3d/linear_1/kernel" in flat and flat["img_proj/kernel_q"].dtype == torch.int8
    port_q = tcm.flatten_paths(tcm.quantize_params(convert.from_jax_params(jparams, cfgs[1], device="cpu")))
    assert port_q.keys() == flat.keys()
    np.testing.assert_array_equal(port_q["lm/embed/embedding_q"].numpy(), jq["lm"]["embed"]["embedding_q"])


def lm_pair(cfgs, qpas):
    """The tiny LM configs with query_pre_attn_scalar set to `qpas` (the tiny
    config has 8 = head_dim: a query scale of head_dim**-0.5 would pass)."""
    jc, tc = cfgs[0].lm, cfgs[1].lm
    return dataclasses.replace(jc, query_pre_attn_scalar=qpas), dataclasses.replace(tc, query_pre_attn_scalar=qpas)


def prompt(cfg, b=2, p=7, seed=3):
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((b, p, cfg.width)).astype(np.float32)
    mask = np.ones((b, p), bool)
    mask[1, -2:] = False  # right padding on row 1
    return embeds, mask


@pytest.mark.parametrize("use_sliding", [True, False])
@pytest.mark.parametrize("qpas", [8.0, 5.0])
def test_gemma2_forward_matches(cfgs, jparams, tparams, use_sliding, qpas):
    """Hidden states and the K/V cache, causal with padding over 7 tokens:
    the window of 3 bites on the even layer when use_sliding is on."""
    jc, tc = lm_pair(cfgs, qpas)
    embeds, pmask = prompt(tc)
    p = embeds.shape[1]
    mask = np.tril(np.ones((p, p), bool))[None] & pmask[:, None, :]
    pos = (np.cumsum(pmask, axis=1) - 1).astype(np.int32)
    jh, (jk, jv) = jax.jit(lambda prm, e, m, q: jgemma2.forward(prm, e, m, q, jc, J32, use_sliding=use_sliding))(
        jparams["lm"], embeds, mask, pos)
    th, (tk, tv) = tgemma2.forward(tparams["lm"], t_(embeds), t_(mask), t_(pos), tc, T32, use_sliding=use_sliding)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    other, _ = tgemma2.forward(tparams["lm"], t_(embeds), t_(mask), t_(pos), tc, T32, use_sliding=not use_sliding)
    assert not torch.allclose(other, th, atol=1e-4)  # the window changes the result


@pytest.mark.parametrize("prefix_full_attention", [True, False])
def test_greedy_decode_matches(cfgs, jparams, tparams, prefix_full_attention):
    """Tokens of the KV-cached decode, with query_pre_attn_scalar != head_dim,
    over more steps than the window (3), a padded prompt row among them."""
    jc, tc = lm_pair(cfgs, 5.0)
    embeds, pmask = prompt(tc, seed=4)
    n = 8
    fn = jax.jit(lambda prm, e, m: jgemma2.greedy_decode(prm, e, m, n, jc, J32, prefix_full_attention))
    ref = np.asarray(fn(jparams["lm"], embeds, pmask))
    out = tgemma2.greedy_decode(tparams["lm"], t_(embeds), t_(pmask), n, tc, T32, prefix_full_attention)
    assert out.shape == (2, n)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(np.unique(ref)) > 2


def test_ego3d_matches(cfgs, jparams, tparams, batch):
    jc, tc = cfgs
    ref = jax.jit(lambda p, d: jsvla.ego3d_position_encoding(p, d, jc, J32))(jparams, batch["depth"])
    out = tsvla.ego3d_position_encoding(tparams, t_(batch["depth"]), tc, T32)
    assert out.shape == (2, tc.vision.num_patches, tc.vision.width)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(tsvla.flat_depth(3, tc, 2.0), jsvla.flat_depth(3, jc, 2.0))


def test_embed_prefix_matches(cfgs, jparams, tparams, batch):
    jc, tc = cfgs
    je, jm = jax.jit(lambda p, *a: jsvla.embed_prefix(p, *a, jc, J32))(jparams, *(batch[k] for k in INPUTS))
    te, tm = tsvla.embed_prefix(tparams, *(t_(batch[k]) for k in INPUTS), tc, T32)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    u8 = np.random.default_rng(0).integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tsvla.normalize_images(t_(u8)).numpy(), np.asarray(jsvla.normalize_images(u8)))


def test_predict_action_tokens_matches(cfgs, jparams, tparams, batch):
    jc, tc = cfgs
    ref = jax_tokens(jc, jparams, batch)
    out = tsvla.predict_action_tokens(tparams, *(t_(batch[k]) for k in INPUTS), tc, T32)
    assert out.shape == (2, tc.tokens_per_action * tc.n_action_steps)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_int8_tokens_and_unembedding_match(cfgs, jparams, batch):
    """The int8 serving tree (jax.jit(quantize_params), carried across):
    tokens equal, and the W8A8 tied unembedding bit-equal to
    jax.jit(cm.unembed_logits) on the same table."""
    jc, tc = cfgs
    jq = jax.tree.map(np.asarray, jax.jit(jcm.quantize_params)(jparams))
    tq = convert.from_jax_params(jq, tc, device="cpu")
    ref = jax_tokens(jc, jq, batch)
    out = tsvla.predict_action_tokens(tq, *(t_(batch[k]) for k in INPUTS), tc, T32)
    np.testing.assert_array_equal(out.numpy(), ref)
    hidden = np.random.default_rng(6).standard_normal((3, 2, tc.lm.width)).astype(np.float32)
    hidden[0, 0] = 0.0  # an all-zero row: the activation scale's floor
    jl = np.asarray(jax.jit(jcm.unembed_logits)(jq["lm"]["embed"], hidden))
    tl = tcm.unembed_logits(tq["lm"]["embed"], t_(hidden))
    assert tl.dtype == torch.float32 and tl.shape == (3, 2, tc.lm.vocab_size)
    np.testing.assert_array_equal(tl.numpy(), jl)
    # the final softcap on top: XLA's and torch's fp32 tanh differ in the last bits
    capped = jax.jit(lambda p, h: jgemma2.logits(p, h, jc.lm))(jq["lm"], hidden)
    np.testing.assert_allclose(tgemma2.logits(tq["lm"], t_(hidden), tc.lm).numpy(), np.asarray(capped), rtol=1e-6,
                               atol=1e-7)


def test_action_tokenizer_and_ensembler_match(cfgs):
    from intact_tpu.envs.adapters.simpler import ActionEnsembler as JEns
    from intact_tpu_torch.envs.adapters.simpler import ActionEnsembler as TEns

    for cfg_pair in (cfgs, (JCfg.spatialvla_4b(), TCfg.spatialvla_4b())):
        jt, tt = jsvla.make_action_tokenizer(cfg_pair[0]), tsvla.make_action_tokenizer(cfg_pair[1])
        rng = np.random.default_rng(7)
        actions = np.concatenate([rng.normal(0, 0.5, (64, 6)), rng.integers(0, 2, (64, 1))], axis=1)
        np.testing.assert_array_equal(tt.encode(actions), jt.encode(actions))
        tokens = tt.encode(actions)
        np.testing.assert_array_equal(tt.decode(tokens), jt.decode(tokens))
        assert tokens.min() >= cfg_pair[1].spatial_offset and tokens.max() < cfg_pair[1].lm.vocab_size
        assert tt.n_spatial_tokens == cfg_pair[1].n_spatial_tokens
    je, te = JEns(pred_horizon=3), TEns(pred_horizon=3)
    rng = np.random.default_rng(8)
    for step in range(5):
        chunk = rng.standard_normal((3, 7))
        np.testing.assert_array_equal(te.ensemble(chunk), je.ensemble(chunk))
        if step == 2:
            je.reset()
            te.reset()


# ---------------------------------------------------------------------------
# the HF importer
# ---------------------------------------------------------------------------

def fake_hf_sd(params, cfg):
    """The reference's fake HF state dict of its own tests
    (tests/test_spatialvla_native.py: the importer's inverse)."""
    from tests.test_spatialvla_native import _fake_spatialvla_sd

    return _fake_spatialvla_sd(params, cfg)


def assert_tree_equal(tree, params):
    got = tcm.flatten_paths(tree)
    for k, v in tcm.flatten_paths(params).items():
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(v, np.float32), err_msg=k)


@pytest.mark.parametrize("nest", ["", "model."])
def test_hf_import_matches_reference(cfgs, jparams, nest):
    """The port's importer on the reference's fake HF layout (plain and
    `model.`-nested) gives the reference importer's tree."""
    jc, tc = cfgs
    sd = {nest + k: v for k, v in fake_hf_sd(jparams, jc).items()}
    out = tsvla.from_hf_state_dict(sd, tc)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in tcm.tree_leaves(out))
    assert_tree_equal(out, jsvla.from_hf_state_dict(sd, jc))
    assert_tree_equal(out, jparams)


def test_hf_import_shape_mismatch_raises(cfgs, jparams):
    sd = fake_hf_sd(jparams, cfgs[0])
    sd["multi_modal_projector.linear.weight"] = np.zeros((3, 5), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        tsvla.from_hf_state_dict(sd, cfgs[1])
    sd = fake_hf_sd(jparams, cfgs[0])
    del sd["language_model.model.norm.weight"]
    with pytest.raises(KeyError):
        tsvla.from_hf_state_dict(sd, cfgs[1])


def test_slice_vocab_rows_matches_reference():
    from intact_tpu.models.hf_import import slice_vocab_rows as jslice
    from intact_tpu_torch.models.hf_import import slice_vocab_rows

    table = np.arange(24, dtype=np.float32).reshape(6, 4)
    for v in (6, 4):
        np.testing.assert_array_equal(slice_vocab_rows(table, v, "t").numpy(), jslice(table, v, "t"))
    with pytest.raises(ValueError, match="vocab rows"):
        slice_vocab_rows(table, 7, "t")


def test_safetensors_snapshot_loads(cfgs, jparams, tmp_path):
    """A sharded snapshot (two files and their index, bf16 and fp32 entries)
    read by the port's own loader: the tokens equal those on the source
    weights rounded the same way."""
    from safetensors.torch import save_file

    jc, tc = cfgs
    sd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in fake_hf_sd(jparams, jc).items()}
    names = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": names[::2], "model-00002-of-00002.safetensors": names[1::2]}
    for i, (fname, keys) in enumerate(shards.items()):
        # the first shard in bf16, as released checkpoints are stored
        save_file({k: sd[k].to(torch.bfloat16) if i == 0 else sd[k] for k in keys}, str(tmp_path / fname))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: f for f, keys in shards.items() for k in keys}}))
    from intact_tpu_torch.models.hf_import import load_safetensors_dir

    loaded = load_safetensors_dir(tmp_path)
    assert loaded.keys() == sd.keys()
    for k in shards["model-00001-of-00002.safetensors"]:
        assert loaded[k].dtype == torch.bfloat16 and torch.equal(loaded[k], sd[k].to(torch.bfloat16))
    for k in shards["model-00002-of-00002.safetensors"]:
        assert loaded[k].dtype == torch.float32 and torch.equal(loaded[k], sd[k])
    params = tcm.tree_map(lambda x: x.float(), tsvla.load_spatialvla_checkpoint(str(tmp_path), tc))
    rounded = tsvla.from_hf_state_dict({k: v.to(torch.bfloat16).float() if k in shards[
        "model-00001-of-00002.safetensors"] else v for k, v in sd.items()}, tc)
    assert_tree_equal(params, tcm.tree_map(lambda x: x.numpy(), rounded))
    with pytest.raises(FileNotFoundError):
        load_safetensors_dir(tmp_path / "missing")


# ---------------------------------------------------------------------------
# the wrapper, through infer_batch and over a websocket
# ---------------------------------------------------------------------------

def pipeline_configs(port: int = 0):
    """(the reference's, the port's) pipeline config of the JAX package's own
    serving test: spatialvla_native_tiny on the Bridge adapter, fp32 params
    and bf16 compute (use_bf16 false), action_step 1."""
    from intact_tpu.config import pipeline as jp
    from intact_tpu_torch.config import pipeline as tp

    out = []
    for mod in (jp, tp):
        out.append(mod.TrainPipelineConfig(
            name="spatialvla_native_serve_test", model_cfg={"type": "spatialvla_native_tiny"}, use_bf16=False,
            tokenizer_path="hash",
            eval_cfg=mod.EvalConfig(simulator_name="simpler", env_adapter="BridgeSimplerAdapter",
                                    task_list=["widowx_carrot_on_plate"], n_eval_episode=1, n_video=0,
                                    recording=False, role="server", host="127.0.0.1", port=port, action_step=1),
            env=mod.EnvConfig(dataset_statistics_path=STATS, image_size=(28, 28))))
    return out


def fp32_predict(jw):
    """The JAX wrapper's fused device call with fp32 compute (its use_bf16
    false means bf16 compute, where XLA's and torch's roundings may flip a
    greedy token of the tiny random model)."""
    cfg = jw.model_cfg
    return jax.jit(lambda p, u8, d, t, m: jsvla.predict_action_tokens(p, jsvla.normalize_images(u8), d, t, m, cfg,
                                                                        J32))


@pytest.fixture(scope="module")
def wrappers():
    """The JAX package's wrapper and the port's (type from the registry), the
    port's on the JAX wrapper's weights, both computing in fp32."""
    from intact_tpu.serve.policy_wrapper import SpatialVLANativePolicyWrapper as JW
    from intact_tpu_torch.serve.policy_wrapper import SpatialVLANativePolicyWrapper, make_policy_wrapper

    jcfg, tcfg = pipeline_configs()
    jw = JW(jcfg)
    tw = make_policy_wrapper(tcfg, device="cpu")
    assert type(tw) is SpatialVLANativePolicyWrapper and not tw.quantize and tw.policy == tcm.DEFAULT_POLICY
    jw._predict, tw.policy = fp32_predict(jw), T32
    tw.params = convert.from_jax_params(jax.tree.map(np.asarray, jw.params), tw.model_cfg, device="cpu")
    return jw, tw


OBS = {
    "observation.images.top": np.random.default_rng(9).integers(0, 256, (64, 64, 3), dtype=np.uint8),
    "observation.state": {"agent": {"eef_pos": np.array([0.1, 0.2, 0.3, 1.0, 0, 0, 0, 0.8])}},
    "task": "put the carrot on the plate",
}


def test_wrapper_infer_batch_matches_reference(wrappers):
    """Three sessions fused into one call (bucket 4), two rounds: each
    session's ensembled env action equals the JAX wrapper's."""
    jw, tw = wrappers
    rng = np.random.default_rng(10)
    cfg = tw.model_cfg
    s, g = cfg.vision.image_size, cfg.vision.grid
    tasks = ["put carrot on plate", "stack the green block on the yellow block", "put the spoon on the towel"]
    jsess, tsess = [jw.new_session() for _ in tasks], [tw.new_session() for _ in tasks]
    for _ in range(2):
        reqs = [{"image": rng.integers(0, 256, (1, s, s, 3), dtype=np.uint8),
                 "depth": rng.uniform(0.5, 2.0, (1, g, g)).astype(np.float32), "task": [task]} for task in tasks]
        out = tw.infer_batch(list(zip(reqs, tsess)))
        ref = jw.infer_batch(list(zip(reqs, jsess)))
        assert [o.shape for o in out] == [(1, 7)] * 3
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o, r, rtol=1e-6, atol=1e-6)
    assert all(len(ss.ensembler.history) == 2 for ss in tsess)
    tsess[0].reset()
    assert not tsess[0].ensembler.history and len(tsess[1].ensembler.history) == 2
    two_rows = tw.new_session()
    two_rows.adapter.preprocess = lambda obs: {"image": np.zeros((2, s, s, 3), np.uint8), "task": ["a", "b"]}
    with pytest.raises(ValueError, match="single-env"):
        two_rows.preprocess(OBS)


def test_wrapper_over_websocket_matches_reference(wrappers, monkeypatch):
    """The server role (python -m intact_tpu_torch.run) serves
    spatialvla_native_tiny from the SpatialVLA yaml over a loopback
    websocket; on the JAX wrapper's weights the client's ensembled actions
    equal the JAX wrapper's select_action on the same observation, and reset
    clears the episode."""
    from intact_tpu_torch.serve.policy_wrapper import SpatialVLANativePolicyWrapper
    from tests.test_torch_serve_stack import Client, serve_role

    jw, _ = wrappers
    argv = ["--config_path", str(EV_YAML), "--eval_cfg.role", "server", "--eval_cfg.env_adapter",
            "BridgeSimplerAdapter", "--eval_cfg.pretrained_model_path", "null", "--model_cfg.type",
            "spatialvla_native_tiny", "--tokenizer_path", "hash", "--use_bf16", "false", "--env.image_size",
            "[28, 28]", "--env.dataset_statistics_path", STATS, "--device", "cpu"]
    served, st = serve_role(argv, monkeypatch)
    try:
        assert type(served) is SpatialVLANativePolicyWrapper and served.model_cfg == TCfg.tiny()
        served.params = convert.from_jax_params(jax.tree.map(np.asarray, jw.params), served.model_cfg, device="cpu")
        served.policy = T32
        c = Client(st.port)
        try:
            got = [np.asarray(c.send(OBS)) for _ in range(2)]
            assert c.send({"reset": True}) == {"status": "reset"}
            got.append(np.asarray(c.send(OBS)))
        finally:
            c.close()
    finally:
        st.stop()
    jw.reset()
    ref = [np.asarray(jw.select_action(OBS)) for _ in range(2)]
    jw.reset()
    ref.append(np.asarray(jw.select_action(OBS)))
    for o, r in zip(got, ref):
        assert o.shape == (1, 7) and np.isfinite(o).all()
        np.testing.assert_allclose(o, r, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2], got[0])  # after the reset the episode starts anew


def test_wrapper_loads_checkpoints(cfgs, jparams, tmp_path):
    """switch_model in int8: an HF snapshot directory goes to the importer
    and lands quantized as the JAX wrapper's checkpoint path quantizes it
    (jcm.quantize_host_tree, bit-equal), a step directory goes to the port's
    checkpoints, a `*.safetensors` file raises; the model generation counts
    the swaps."""
    from safetensors.numpy import save_file

    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper
    from intact_tpu_torch.train import checkpoint as ckpt

    jc, tc = cfgs
    _, tcfg = pipeline_configs()
    tcfg.eval_cfg.quantize_int8 = True
    w = make_policy_wrapper(tcfg, device="cpu")
    assert w.quantize and w.params["lm"]["embed"]["embedding_q"].dtype == torch.int8
    snap = tmp_path / "snapshot"
    snap.mkdir()
    sd = {k: np.ascontiguousarray(v, np.float32) for k, v in fake_hf_sd(jparams, jc).items()}
    save_file(sd, str(snap / "model.safetensors"))
    w.switch_model(str(snap))
    jq = jcm.quantize_host_tree(jsvla.from_hf_state_dict(sd, jc), jcm.DEFAULT_POLICY)
    want = tcm.flatten_paths(convert.from_jax_params(jax.tree.map(np.asarray, jq), tc, device="cpu"))
    got = tcm.flatten_paths(w.params)
    assert got.keys() == want.keys() and w.model_generation == 1
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    step = ckpt.save_checkpoint(tmp_path / "ckpt", tsvla.init(tc, seed=3, device="cpu"), step=2)
    w.switch_model(str(step))
    assert w.model_generation == 2 and w.params["img_proj"]["kernel_q"].dtype == torch.int8
    with pytest.raises(ValueError, match="safetensors FILE"):
        w.switch_model(str(snap / "model.safetensors"))


def test_registry_types_and_unported_scaffold(cfgs):
    from intact_tpu_torch.models import registry
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    _, tcfg = pipeline_configs()
    assert tcfg.make_model_config() == cfgs[1]
    tcfg.model_cfg = {"type": "spatialvla_native"}
    assert tcfg.make_model_config() == TCfg.spatialvla_4b()
    assert registry.module("spatialvla_native") is tsvla
    tcfg.model_cfg = {"type": "spatialvla"}  # the HF-scaffold wrapper: it raises without the upstream asset
    with pytest.raises(RuntimeError, match="spatialvla_native"):
        make_policy_wrapper(tcfg, device="cpu")


def test_full_width_shapes_on_meta():
    """SpatialVLA-4B on the meta device: 3.04 B parameters, the tied table
    259,714 x 2304, and its int8 form's codes K-major for the W8A8 kernel."""
    cfg = TCfg.spatialvla_4b()
    params = tsvla.init(cfg, device="meta")
    n = sum(x.numel() for x in tcm.tree_leaves(params))
    assert 3.0e9 < n < 3.1e9
    assert params["lm"]["embed"]["embedding"].shape == (259_714, 2304) and cfg.spatial_offset == 257_152
    q = tcm.quantize_params(params)
    assert q["lm"]["embed"]["embedding_q"].shape == (259_714, 2304)
    assert q["lm"]["blocks"]["mlp"]["down"]["kernel_q"].shape == (26, 2304, 9216)
