"""The PyTorch port's Octo importers (convert_octo_params, the flax msgpack
codec, load_octo_checkpoint), T5's HF import, the LeRobot Pi0 importer, and
Octo's serving wrapper, session and Bridge adapter against the JAX
package's, on the CPU (the models themselves: tests/test_torch_octo.py).

Tolerances, each with the value measured when it was set:
  * T5 against transformers' T5EncoderModel on the real positions: 1e-5
    relative L2 (measured 0: the same torch ops);
  * the wrapper's env actions against the JAX wrapper's, both in fp32 on
    the same weights with the JAX draws replayed: 1e-4 relative L2, as the
    sampled actions in tests/test_torch_octo.py;
  * convert_octo_params, the msgpack decoder, to_released_tree, the LeRobot
    import, the session's fused inputs and the adapter: exact.
No test opens a socket.
"""

import json
import logging
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intact_tpu.models.octo import upstream as jup
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models import t5 as tt5
from intact_tpu_torch.models.octo import model as toct
from intact_tpu_torch.models.octo import upstream as tup
from intact_tpu_torch.models.octo.config import OctoConfig as TOcto
from intact_tpu_torch.utils import flax_msgpack
from tests.test_octo_upstream import synthetic_checkpoint
from tests.test_torch_octo import ENC_RTOL, J32, SAMPLE_RTOL, T32, ddpm_draws, flat_np, rel

REPO = Path(__file__).resolve().parent.parent
STATS = str(REPO / "config/dataset/bridge_statistics.json")


def test_t5_matches_transformers():
    """A tiny local transformers T5EncoderModel (random weights, nothing
    downloaded) through `from_hf_state_dict`, on the real positions."""
    from transformers import T5Config, T5EncoderModel

    cfg = tt5.tiny_test_config()
    hf_cfg = T5Config(vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv, d_ff=cfg.d_ff,
                      num_heads=cfg.num_heads, num_layers=cfg.num_layers,
                      relative_attention_num_buckets=cfg.rel_buckets,
                      relative_attention_max_distance=cfg.rel_max_distance, feed_forward_proj="relu",
                      dropout_rate=0.0, attn_implementation="eager")
    torch.manual_seed(0)
    hf = T5EncoderModel(hf_cfg).eval().float()
    params = tt5.from_hf_state_dict(hf.state_dict(), cfg)
    assert {k: tuple(v.shape) for k, v in tcm.flatten_paths(params).items()} == {
        k: tuple(v.shape) for k, v in tcm.flatten_paths(tt5.init(cfg, device="meta")).items()}
    ids = torch.tensor([[3, 17, 42, 8, 1, 0, 0], [5, 5, 96, 1, 0, 0, 0]])
    mask = ids > 0
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=mask.long()).last_hidden_state
        ours = tt5.encode(params, ids, mask, cfg, T32)
    for b in range(2):
        n = int(mask[b].sum())
        assert rel(ours[b, :n].numpy(), ref[b, :n].numpy()) <= ENC_RTOL


# ---------------------------------------------------------------------------
# importers: convert_octo_params, the msgpack codec, load_octo_checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture
def jitted_reference_init(monkeypatch):
    """The reference converter starts from `init(key(0), cfg)` (every leaf is
    overwritten under strict); run eagerly, its dispatch of each op costs
    most of this file's time, so it runs jitted here (the same values)."""
    monkeypatch.setattr(jup, "init", jax.jit(jup.init, static_argnums=1))


def test_convert_octo_params_bit_equal(jitted_reference_init):
    jc, tc = jup.tiny_test_config(), tup.tiny_test_config()
    ckpt = synthetic_checkpoint(jc)
    ref = flat_np(jax.tree.map(np.asarray, jup.convert_octo_params(ckpt, jc, strict=True)))
    ours = {k: v.numpy() for k, v in tcm.flatten_paths(tup.convert_octo_params(ckpt, tc, strict=True)).items()}
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == np.float32 and np.array_equal(ours[k], ref[k]), k


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_convert_octo_params_refuses(fault):
    cfg = tup.tiny_test_config()
    ckpt = synthetic_checkpoint(cfg)
    if fault == "missing":
        del ckpt["octo_transformer"]["BlockTransformer_0"]["Transformer_0"]["encoderblock_0"]["MlpBlock_0"]
        with pytest.raises(ValueError, match="did not match"):
            tup.convert_octo_params(ckpt, cfg)
    else:
        ckpt["octo_transformer"]["obs_primary_projection"]["kernel"] = np.zeros((3, 3), np.float32)
        with pytest.raises(ValueError, match="shape mismatch"):
            tup.convert_octo_params(ckpt, cfg)


def test_to_released_tree_inverts_the_converter():
    cfg = tup.tiny_test_config()
    ckpt = synthetic_checkpoint(cfg)
    params = tup.convert_octo_params(ckpt, cfg)
    released = flat_np(tup.to_released_tree(params, cfg))
    assert released.keys() == flat_np(ckpt).keys()
    for k, v in flat_np(ckpt).items():
        assert np.array_equal(released[k], v), k
    again = tup.convert_octo_params(tup.to_released_tree(params, cfg), cfg)
    for k, v in tcm.flatten_paths(params).items():
        assert torch.equal(tcm.flatten_paths(again)[k], v), k


def test_msgpack_decoder_bit_equal_to_flax(monkeypatch):
    """flax's own msgpack bytes (arrays of several dtypes, bfloat16, numpy
    scalars, nested lists, and a chunked array) decode bit for bit."""
    from flax import serialization

    rng = np.random.default_rng(5)
    tree = {
        "params": synthetic_checkpoint(tup.tiny_test_config()),
        "extra": {"i64": np.arange(-3, 9, dtype=np.int64).reshape(3, 4), "u8": rng.integers(0, 256, 17, np.uint8),
                  "f16": rng.standard_normal((2, 3)).astype(np.float16), "mask": np.array([True, False, True]),
                  "bf16": np.asarray(jnp.asarray(rng.standard_normal(9), jnp.bfloat16)),
                  "scalar": np.float32(2.5), "step": 123456, "neg": -70000, "rate": 0.5, "name": "octo" * 20,
                  "seq": [1, "two", 3.0], "none": None, "flag": True, "empty": np.zeros((0, 4), np.float32)},
        "chunked": rng.standard_normal(300).astype(np.float32),
    }
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)  # splits "chunked" into 4-byte... chunks
    data = serialization.msgpack_serialize(tree)
    ref = serialization.msgpack_restore(data)
    ours = flax_msgpack.unpackb(data)

    def check(a, b, path="."):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys(), path
            for k in b:
                check(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, np.ndarray) and b.dtype.name == "bfloat16":
            assert a.dtype == np.float32 and np.array_equal(a, b.astype(np.float32)), path
        elif isinstance(b, (np.ndarray, np.generic)):
            assert type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape, path
            assert np.array_equal(a, b), path
        else:
            assert type(a) is type(b) and a == b, path

    check(ours, ref)
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.unpackb(data + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpackb(data[:-5])


def test_msgpack_writer_reads_back_in_flax():
    from flax import serialization

    tree = {"params": synthetic_checkpoint(tup.tiny_test_config()), "step": 7, "scale": np.float32(0.25),
            "name": "x" * 300, "big": 2**40, "list": [1, -2, 3.5]}
    back = serialization.msgpack_restore(flax_msgpack.packb(tree))
    for k, v in flat_np(tree["params"]).items():
        assert np.array_equal(flat_np(back["params"])[k], v), k
    assert (back["step"], back["scale"], back["name"], back["big"], back["list"]) == (7, 0.25, "x" * 300, 2**40,
                                                                                      [1, -2, 3.5])
    assert flax_msgpack.unpackb(flax_msgpack.packb(tree))["list"] == [1, -2, 3.5]


@pytest.mark.parametrize("wrap", ["bare", "params", "model"])
def test_load_octo_checkpoint_matches_reference(tmp_path, wrap, jitted_reference_init):
    """A snapshot holding flax's msgpack (wrapped as releases may wrap it)
    loads bit-equal to the JAX loader's."""
    from flax import serialization

    jc, tc = jup.tiny_test_config(), tup.tiny_test_config()
    tree = synthetic_checkpoint(jc)
    tree = {"bare": tree, "params": {"params": tree}, "model": {"model": {"params": tree}}}[wrap]
    (tmp_path / "octo.msgpack").write_bytes(serialization.msgpack_serialize(tree))
    ref = flat_np(jax.tree.map(np.asarray, jup.load_octo_checkpoint(str(tmp_path), jc)))
    ours = tcm.flatten_paths(tup.load_octo_checkpoint(str(tmp_path), tc))
    assert ours.keys() == ref.keys() and all(np.array_equal(ours[k].numpy(), ref[k]) for k in ref)


def test_load_octo_checkpoint_refuses_orbax_and_empty_dirs(tmp_path):
    cfg = tup.tiny_test_config()
    with pytest.raises(FileNotFoundError, match="no octo params"):
        tup.load_octo_checkpoint(str(tmp_path), cfg)
    (tmp_path / "params").mkdir()
    (tmp_path / "params" / "_METADATA").write_text("{}")
    with pytest.raises(RuntimeError, match="needs JAX"):
        tup.load_octo_checkpoint(str(tmp_path), cfg)


# ---------------------------------------------------------------------------
# the LeRobot Pi0 importer
# ---------------------------------------------------------------------------

def test_lerobot_import_equals_the_weight_bridge(tmp_path):
    """The JAX to_torch_state_dict of a tiny Pi0 init, saved as safetensors
    and imported with the port's entry, equals convert.py's params bit for
    bit; the port's own to_torch_state_dict equals the JAX one; Pi0Policy
    loads the step dir."""
    from safetensors.numpy import save_file

    from intact_tpu.models.pi0 import model as jpi0
    from intact_tpu.models.pi0.config import Pi0Config as JPi0
    from intact_tpu.models.pi0.convert import to_torch_state_dict as j_to_sd
    from intact_tpu_torch.models.pi0 import convert as tconv
    from intact_tpu_torch.models.pi0.config import Pi0Config as TPi0
    from intact_tpu_torch.models.pi0.import_lerobot import main as import_main
    from intact_tpu_torch.models.pi0.policy import Pi0Policy
    from intact_tpu_torch.train import checkpoint as ckpt

    jc, tc = JPi0.tiny(), TPi0.tiny()
    jp = jax.tree.map(np.asarray, jax.jit(jpi0.init, static_argnums=1)(jax.random.key(2), jc))
    sd = {k: np.ascontiguousarray(v) for k, v in j_to_sd(jp, jc).items()}
    (tmp_path / "src").mkdir()
    save_file(sd, str(tmp_path / "src" / "model.safetensors"))
    assert import_main(["--src", str(tmp_path / "src"), "--out", str(tmp_path / "out"), "--step", "7",
                        "--tiny"]) == 0
    want = tcm.flatten_paths(convert.from_jax_params(jp, tc, device="cpu"))
    got = tcm.flatten_paths(ckpt.restore_params(tmp_path / "out"))
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    assert json.loads((tmp_path / "out" / "step_7" / "auxiliary_data.json").read_text())["cnt_update"] == 7
    ours = tconv.to_torch_state_dict(tcm.unflatten_paths(want), tc)
    assert ours.keys() == sd.keys() and all(np.array_equal(ours[k].numpy(), sd[k]) for k in sd)
    file_tree = tcm.flatten_paths(tconv.load_safetensors_checkpoint(tmp_path / "src" / "model.safetensors", tc))
    assert all(torch.equal(file_tree[k], want[k]) for k in want)
    policy = Pi0Policy(tc, tokenizer_path="hash", use_bf16=False, device="cpu")
    policy.load(str(tmp_path / "out"))
    assert all(torch.equal(tcm.flatten_paths(policy.params)[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# serving: the session, the wrapper, the adapter, the trainer's refusal
# ---------------------------------------------------------------------------

def pipeline_config(mod, model_type: str = "octo_tiny", **eval_kw):
    """A server-role pipeline config of `mod` (the reference's or the
    port's config module) for Octo on the Octo Bridge adapter."""
    size = 32
    return mod.TrainPipelineConfig(
        name="octo_serve_test", model_cfg={"type": model_type}, use_bf16=False, tokenizer_path="hash",
        eval_cfg=mod.EvalConfig(simulator_name="simpler", env_adapter="OctoBridgeSimplerAdapter",
                                task_list=["widowx_carrot_on_plate"], n_eval_episode=1, n_video=0, recording=False,
                                role="server", **eval_kw),
        env=mod.EnvConfig(dataset_statistics_path=STATS, image_size=(size, size)))


def obs(seed: int, size: int = 32) -> dict:
    return {
        "observation.images.top": np.random.default_rng(seed).integers(0, 256, (size, size, 3), dtype=np.uint8),
        "observation.state": {"agent": {"eef_pos": np.array([0.1, 0.2, 0.3, 1.0, 0, 0, 0, 0.8])}},
        "task": "put the carrot on the plate",
    }


def port_wrapper(model_type: str = "octo_tiny", **eval_kw):
    from intact_tpu_torch.config import pipeline as tp
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    return make_policy_wrapper(pipeline_config(tp, model_type, **eval_kw), device="cpu")


def test_session_history_padding_and_reset_match_reference():
    """OctoSession's fused inputs equal the reference session's over an
    episode (the first request front-pads with its frame, masks False; then
    the deque slides), a reset clears only its own history (a co-batched
    neighbour keeps its own), and a 2-row request or a frame of another size
    raises."""
    from intact_tpu.config import pipeline as jpipe
    from intact_tpu.serve.policy_wrapper import OctoSession as JSession
    from intact_tpu.utils.pipeline import get_class_from_path

    tw = port_wrapper()
    jcfg = pipeline_config(jpipe)
    jsession = JSession(types.SimpleNamespace(model_cfg=tw.model_cfg),
                        get_class_from_path(jcfg.eval_cfg.env_adapter_path)(jcfg))
    s1, s2 = tw.new_session(), tw.new_session()
    frames = []
    for i in range(3):
        o = obs(i)
        ours, ref = s1.preprocess(o), jsession.preprocess(o)
        assert ours.keys() == ref.keys()
        for k in ("images", "img_masks", "state"):
            assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), (i, k)
        assert ours["task"] == ref["task"]
        frames.append(ours["images"][0, -1])
        s2.preprocess(obs(10 + i))
    assert len(s1.history) == 2 and np.array_equal(s1.history[0], frames[1])
    s1.reset()
    out = s1.preprocess(obs(5))
    assert out["img_masks"].tolist() == [[False, True]] and np.array_equal(out["images"][0, 0], out["images"][0, 1])
    assert len(s2.history) == 2  # the neighbour's history is untouched
    two_rows = tw.new_session()
    two_rows.adapter.preprocess = lambda o: {"image": np.zeros((2, 32, 32, 3), np.uint8), "state": np.zeros((2, 7)),
                                             "task": ["a", "b"]}
    with pytest.raises(ValueError, match="single-env"):
        two_rows.preprocess(obs(0))
    wrong = tw.new_session()
    wrong.adapter.preprocess = lambda o: {"image": np.zeros((1, 28, 28, 3), np.uint8), "state": np.zeros((1, 7)),
                                          "task": ["a"]}
    with pytest.raises(ValueError, match="env.image_size"):
        wrong.preprocess(obs(0))


class ReplayModel:
    """The port's Octo module with the JAX wrapper's draws for its calls: the
    key the reference splits off per inference, its DDPM x_T and step noise."""

    def __init__(self, jw):
        self.jw, self.calls = jw, 0

    def __getattr__(self, name):
        return getattr(toct, name)

    def sample_actions(self, params, generator, images, *args, **kw):
        cfg = self.jw.model_cfg
        _, key = jax.random.split(self.jw._rng)
        x_T, draws = ddpm_draws(key, (images.shape[0], cfg.horizon, cfg.action_dim), cfg.diffusion_steps)
        self.calls += 1
        return toct.sample_actions(params, generator, images, *args, noise=x_T, step_noise=draws, **kw)


def test_wrapper_infer_batch_matches_reference():
    """octo_tiny through the registry's wrapper, without a socket: three
    sessions fused (bucket 4) over two rounds equal the JAX wrapper's env
    actions, both computing in fp32 on the JAX wrapper's weights with its
    draws replayed."""
    from intact_tpu.config import pipeline as jpipe
    from intact_tpu.models.octo import model as jmodel
    from intact_tpu.serve.policy_wrapper import OctoPolicyWrapper as JW
    from intact_tpu_torch.serve.policy_wrapper import OctoPolicyWrapper

    jw, tw = JW(pipeline_config(jpipe)), port_wrapper()
    assert type(tw) is OctoPolicyWrapper and tw.policy == tcm.DEFAULT_POLICY
    cfg = jw.model_cfg

    def sample(params, key, images, img_masks, lang_tokens, lang_masks, state):
        images = images.astype(jnp.float32) * (2.0 / 255.0) - 1.0
        return jmodel.sample_actions(params, key, images, img_masks, lang_tokens, lang_masks, state, cfg, J32)

    jw._sample = jax.jit(sample)
    tw.policy = T32
    tw.params = convert.from_jax_params(jax.tree.map(np.asarray, jw.params), tw.model_cfg, device="cpu")
    tw.model = replay = ReplayModel(jw)
    tasks = ["put carrot on plate", "stack the green block on the yellow block", "put the spoon on the towel"]
    jsess, tsess = [jw.new_session() for _ in tasks], [tw.new_session() for _ in tasks]
    for r in range(2):
        o = [obs(10 * r + i) for i in range(3)]
        out = tw.infer_batch([(s.preprocess(x), s) for s, x in zip(tsess, o)])
        ref = jw.infer_batch([(s.preprocess(x), s) for s, x in zip(jsess, o)])
        assert [a.shape for a in out] == [(cfg.horizon, 7)] * 3
        for a, b in zip(out, ref):
            assert rel(a, b) <= SAMPLE_RTOL
    assert replay.calls == 2


def test_wrapper_switch_model_and_refusals(tmp_path, monkeypatch):
    """The upstream types load a released msgpack snapshot (bit-equal to the
    converter's tree) and the native ones a port step dir; quantize_int8
    raises; an upstream wrapper without a tokenizer asset falls back to the
    hash tokenizer with a warning."""
    from intact_tpu_torch.models import registry
    from intact_tpu_torch.train import checkpoint as ckpt

    for name in ("octo_small_upstream", "octo_base_upstream"):
        monkeypatch.setitem(registry._REGISTRY, name, {**registry.get(name),
                                                       "default_config": tup.tiny_test_config})
    cfg = tup.tiny_test_config()
    snapshot = tmp_path / "octo-small-1.5"
    snapshot.mkdir()
    (snapshot / "params.msgpack").write_bytes(flax_msgpack.packb({"params": synthetic_checkpoint(cfg)}))
    up = port_wrapper("octo_small_upstream", pretrained_model_path=str(snapshot))
    assert up.model is tup and up.model_generation == 1
    want = tcm.flatten_paths(tup.convert_octo_params(synthetic_checkpoint(cfg), cfg))
    assert all(torch.equal(tcm.flatten_paths(up.params)[k], want[k]) for k in want)

    native = port_wrapper()
    saved = ckpt.save_checkpoint(tmp_path / "native", native.params, step=3)
    other = port_wrapper()
    other.params = tcm.tree_map(torch.zeros_like, other.params)
    other.switch_model(str(saved))
    assert all(torch.equal(a, b) for a, b in zip(tcm.tree_leaves(other.params), tcm.tree_leaves(native.params)))
    with pytest.raises(NotImplementedError, match="int8"):
        port_wrapper(quantize_int8=True)


def test_upstream_wrapper_falls_back_to_the_hash_tokenizer(monkeypatch, caplog):
    from intact_tpu_torch.config import pipeline as tp
    from intact_tpu_torch.models import registry
    from intact_tpu_torch.models.tokenizer import HashTokenizer
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    monkeypatch.setitem(registry._REGISTRY, "octo_small_upstream", {**registry.get("octo_small_upstream"),
                                                                    "default_config": tup.tiny_test_config})
    monkeypatch.delenv("VLA_TOKENIZER_PATH", raising=False)
    cfg = pipeline_config(tp, "octo_small_upstream")
    cfg.tokenizer_path = None
    logger = logging.getLogger("policy_wrapper")  # the wrapper's logger does not propagate
    logger.addHandler(caplog.handler)
    try:
        w = make_policy_wrapper(cfg, device="cpu")
    finally:
        logger.removeHandler(caplog.handler)
    assert isinstance(w.tokenizer, HashTokenizer) and "t5-base tokenizer asset unavailable" in caplog.text
    assert int(w.tokenizer(["a task"], 6)[0].max()) < tup.tiny_test_config().t5.vocab_size
    inputs = w.session.preprocess(obs(1))  # the tiny config's 3-d actions do not fit the Bridge postprocess
    chunk = w.sample_chunk(inputs["images"], inputs["img_masks"], inputs["task"], inputs["state"])
    assert chunk.shape == (1, 2, 3) and np.isfinite(chunk).all()


@pytest.mark.parametrize("model_type", ["octo_tiny", "octo_small_upstream"])
def test_wrapper_prewarms_every_bucket(model_type, monkeypatch):
    """warmup_inputs fits both configs (the released one has no proprio
    width; the reference's warmup reads one and raises there) and prewarm
    runs each bucket."""
    from intact_tpu_torch.models import registry

    monkeypatch.setitem(registry._REGISTRY, "octo_small_upstream", {**registry.get("octo_small_upstream"),
                                                                    "default_config": tup.tiny_test_config})
    w = port_wrapper(model_type, max_batch_size=4)
    calls = []
    real = w.sample_chunk
    w.sample_chunk = lambda *a: calls.append(a[0].shape[0]) or real(*a)
    w.prewarm()
    assert calls == [1, 2, 4]


def test_registry_types():
    from intact_tpu_torch.config import pipeline as tp
    from intact_tpu_torch.models import registry

    for name, cfg_cls, mod in (("octo", TOcto, toct), ("octo_tiny", TOcto, toct),
                               ("octo_small_upstream", tup.OctoUpstreamConfig, tup),
                               ("octo_base_upstream", tup.OctoUpstreamConfig, tup)):
        entry = registry.get(name)
        assert entry["wrapper"].endswith("OctoPolicyWrapper") and registry.module(name) is mod
        assert isinstance(pipeline_config(tp, name).make_model_config(), cfg_cls)
    assert tp.TrainPipelineConfig(model_cfg={"type": "octo_base_upstream"}).make_model_config() == tup.octo_base()
    assert registry.module_for_config(tt5.tiny_test_config()) is tt5


def test_trainer_refuses_octo_with_its_reason():
    from intact_tpu_torch.config import pipeline as tp
    from intact_tpu_torch.train.trainer import Trainer

    with pytest.raises(NotImplementedError, match="no `vision` field"):
        Trainer(tp.TrainPipelineConfig(model_cfg={"type": "octo_tiny"}), device="cpu")


@pytest.mark.parametrize("uint8", [False, True])
@pytest.mark.parametrize("resize", ["tensorflow", "cv2"])
def test_adapter_matches_reference(uint8, resize, monkeypatch):
    """OctoBridgeSimplerAdapter against the reference's on a 64 -> 32 px
    frame: TF lanczos3 (antialias, rounded) or, without TF, cv2 Lanczos4;
    gaussian denormalization in the postprocess."""
    from intact_tpu.config import pipeline as jpipe
    from intact_tpu.envs.adapters.simpler import OctoBridgeSimplerAdapter as JA
    from intact_tpu_torch.config import pipeline as tp
    from intact_tpu_torch.envs.adapters.simpler import OctoBridgeSimplerAdapter as TA

    if resize == "cv2":
        monkeypatch.setitem(sys.modules, "tensorflow", None)  # import raises ImportError
    ja, ta = JA(pipeline_config(jpipe)), TA(pipeline_config(tp))
    ja.output_uint8 = ta.output_uint8 = uint8
    o = obs(3, size=64)
    ours, ref = ta.preprocess(o), ja.preprocess(o)
    assert ours.keys() == ref.keys() and ours["task"] == ref["task"]
    for k in ("image", "state"):
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k
    assert ours["image"].shape == (1, 32, 32, 3)
    actions = np.random.default_rng(4).uniform(-1, 1, (4, 7)).astype(np.float32)
    assert ta.action_normalization_type == "gaussian"
    np.testing.assert_array_equal(ta.postprocess(actions), ja.postprocess(actions))
