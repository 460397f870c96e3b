"""The PyTorch port's MVLA family against the JAX package's, on the CPU.

Both run `MVLAConfig.tiny()` (its "joint" variant for mmmvla) in fp32
(`DtypePolicy(float32, float32)` on both sides) on parameters made by the JAX
`mvla.init` (one jitted init per pattern, shared by the module) and carried
across by `intact_tpu_torch.convert.from_jax_params`; inputs come from a
seeded numpy generator, with two rows of different language length, and the
flow noise and time are the JAX draws, fed to the port. The JAX side runs
compiled (`jax.jit`), its attention kernel as the JAX package's own tests run
it on the CPU. Tolerances, each with its reason:
  * connector, prompt, expert outputs, velocities, actions: 1e-4 relative L2
    (as tests/test_torch_pi0.py): the same fp32 ops, products and reductions summed
    in another order through a few dozen layers;
  * the cached and uncached expert paths within one package: 2e-5 (the JAX
    package's own check), the cross K/V taken with or without a cache: equal;
  * loss 1e-5 relative; gradients 1e-4 relative L2 per leaf (SigLIP's key
    biases, whose exact gradient is 0, within 1e-6 of the gradient's norm);
    a leaf the loss does not reach: exactly 0 on both sides;
  * DiT and DDIM: 1e-5 relative L2 (a few fp32 layers; the DDIM steps
    divide by sqrt(alphas_cumprod), which amplifies the first step's
    rounding by up to ~1e2 in absolute terms, not in relative L2);
  * int8 actions: relative L2 2e-2, max abs 0.1, as tests/test_torch_int8.py
    says why (an activation within fp32 noise of a rounding tie takes the
    other int8 code).
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
from intact_tpu.models import connector as jconn
from intact_tpu.models import diffusion as jdiff
from intact_tpu.models import dit as jdit
from intact_tpu.models.mvla import expert as jexpert
from intact_tpu.models.mvla import model as jmvla
from intact_tpu.models.mvla.config import MVLAConfig as JCfg
from intact_tpu.models.pi0 import model as jpi0
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models import connector as tconn
from intact_tpu_torch.models import diffusion as tdiff
from intact_tpu_torch.models import dit as tdit
from intact_tpu_torch.models.mvla import expert as texpert
from intact_tpu_torch.models.mvla import model as tmvla
from intact_tpu_torch.models.mvla.config import MVLAConfig as TCfg

J32 = jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
T32 = tcm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
INPUTS = ("images", "img_masks", "lang_tokens", "lang_masks")
RTOL = 1e-4
REPO = Path(__file__).resolve().parent.parent


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def t_(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def cfg_pair(pattern="self_cross", **kw):
    return (dataclasses.replace(JCfg.tiny(), alternate_pattern=pattern, **kw),
            dataclasses.replace(TCfg.tiny(), alternate_pattern=pattern, **kw))


_MODELS: dict = {}


def build(pattern: str):
    """(jax cfg, port cfg, jax params, port params) of one expert pattern,
    made once per test process."""
    if pattern not in _MODELS:
        jc, tc = cfg_pair(pattern)
        jp = jax.jit(jmvla.init, static_argnums=1)(jax.random.key(0), jc)
        _MODELS[pattern] = (jc, tc, jp, convert.from_jax_params(jax.tree.map(np.asarray, jp), tc, device="cpu"))
    return _MODELS[pattern]


@pytest.fixture(scope="module", params=["self_cross", "joint"])
def model(request):
    return build(request.param)


@pytest.fixture(scope="module")
def batch():
    cfg = TCfg.tiny()
    rng = np.random.default_rng(1)
    b, s = 2, cfg.vision.image_size
    lang_masks = np.zeros((b, cfg.tokenizer_max_length), bool)
    lang_masks[0, :6] = True
    lang_masks[1, :3] = True  # ragged language padding
    action_is_pad = np.zeros((b, cfg.chunk_size), bool)
    action_is_pad[1, -1] = True
    return {
        "images": rng.uniform(-1, 1, (b, cfg.num_cameras, s, s, 3)).astype(np.float32),
        "img_masks": np.ones((b, cfg.num_cameras), bool),
        "lang_tokens": rng.integers(0, 200, (b, cfg.tokenizer_max_length)).astype(np.int32),
        "lang_masks": lang_masks,
        "state": rng.standard_normal((b, cfg.max_state_dim), dtype=np.float32),
        "actions": rng.uniform(-1, 1, (b, cfg.chunk_size, cfg.max_action_dim)).astype(np.float32),
        "action_is_pad": action_is_pad,
        "noise": rng.standard_normal((b, cfg.chunk_size, cfg.max_action_dim), dtype=np.float32),
        "x_t": rng.standard_normal((b, cfg.chunk_size, cfg.max_action_dim), dtype=np.float32),
        "time": np.array([0.3, 0.8], np.float32),
    }


_PROMPTS: dict = {}


def prompts(model, batch):
    """(the reference's prompt, the port's) for the fixture batch."""
    jc, tc, jp, tp = model
    if jc.alternate_pattern not in _PROMPTS:
        _PROMPTS[jc.alternate_pattern] = np.asarray(jax.jit(lambda p, *a: jmvla.compute_prompt(p, *a, jc, J32))(
            jp, *(batch[k] for k in INPUTS)))
    return _PROMPTS[jc.alternate_pattern], tmvla.compute_prompt(tp, *(t_(batch[k]) for k in INPUTS), tc, T32)


@pytest.mark.parametrize("mtype", ["mvla", "mmmvla"])
def test_model_config_from_the_json_matches_reference(mtype):
    """The server role's yaml with config/models/mvla_bridge.json as its
    model_cfg: make_model_config gives the reference's config (the default
    MVLA config with the JSON's common fields) in both packages."""
    from intact_tpu.config import TrainPipelineConfig as JP
    from intact_tpu.config import from_dict as j_from_dict
    from intact_tpu.config import load_yaml as j_load_yaml
    from intact_tpu_torch.config import TrainPipelineConfig as TP
    from intact_tpu_torch.config import from_dict as t_from_dict
    from intact_tpu_torch.config import load_yaml as t_load_yaml

    ev = REPO / "config/experiment/simpler/pi0_finetune_bridge_ev.yaml"
    model_cfg = {**json.loads((REPO / "config/models/mvla_bridge.json").read_text()), "type": mtype}
    ref = j_from_dict(JP, {**j_load_yaml(ev), "model_cfg": model_cfg}).make_model_config()
    cfg = t_from_dict(TP, {**t_load_yaml(ev), "model_cfg": dict(model_cfg)}).make_model_config()
    assert isinstance(cfg, TCfg) and dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert (cfg.chunk_size, cfg.num_metaqueries, cfg.max_action_dim) == (50, 108, 7)
    assert cfg.alternate_pattern == ("joint" if mtype == "mmmvla" else "self_cross")


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------

def test_bridge_fills_every_parameter(model):
    jc, _, jp, tp = model
    jflat = tcm.flatten_paths(jax.tree.map(np.asarray, jp))
    tflat = tcm.flatten_paths(tp)
    assert jflat.keys() == tflat.keys()
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(v), err_msg=k)
    assert ("pairs" in tp["expert"]) == (jc.alternate_pattern == "self_cross")


def test_quantized_tree_carries_across(model):
    """The reference's int8 tree carries across, kernel_q transposed to
    K-major, and the port's quantize_params of the fp tree quantizes exactly
    the same leaves to the same codes: the self/cross pairs (or the joint
    blocks), the connector's and the towers' blocks and img_proj; the
    connector's in/out projections, the metaqueries and the heads stay fp."""
    _, tc, jp, tp = model
    jq = convert.from_jax_params(jax.tree.map(np.asarray, jax.jit(jcm.quantize_params)(jp)), tc, device="cpu")
    tq = tcm.flatten_paths(tcm.quantize_params(tp))
    jq = tcm.flatten_paths(jq)
    assert jq.keys() == tq.keys()
    for k, v in jq.items():
        assert v.dtype == tq[k].dtype and torch.equal(v, tq[k]), k
    quantized = {k[:-len("/kernel_q")] for k in tq if k.endswith("/kernel_q")}
    assert {"connector/blocks/mlp/up", "img_proj", "siglip/blocks/mlp/fc1"} <= quantized
    assert not quantized & {"connector/in_proj", "connector/out_proj", "action_out_proj", "state_proj"}
    expert = {k for k in quantized if k.startswith("expert/")}
    if "pairs" in tp["expert"]:
        assert {"expert/pairs/self/attn/q", "expert/pairs/cross/attn/k", "expert/pairs/cross/mlp/down"} <= expert
        assert len(expert) == 7 + 7
    else:
        assert len(expert) == 7 and "expert/blocks/attn/q" in expert


def test_bridge_raises_on_leftovers(model):
    _, tc, jp, _ = model
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError, match="unconsumed"):
        convert.from_jax_params({**tree, "dit": {"x": np.zeros(3)}}, tc, device="cpu")


def test_odd_expert_depth_raises():
    from intact_tpu_torch.models.gemma import tiny_test_config

    with pytest.raises(ValueError, match="even layer count"):
        texpert.init_params(tcm.Initializer(0, torch.device("cpu"), torch.float32),
                            tiny_test_config(width=16, depth=3), 16)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_connector_apply_matches(model):
    jc, tc, jp, tp = model
    x = np.random.default_rng(2).standard_normal((2, tc.num_metaqueries, tc.vlm.width), dtype=np.float32)
    ref = jax.jit(lambda p, x: jconn.apply(p, x, jc.connector, J32))(jp["connector"], x)
    out = tconn.apply(tp["connector"], t_(x), tc.connector, T32)
    assert out.shape == (2, tc.num_metaqueries, tc.proj_width)
    assert rel(out.numpy(), ref) <= RTOL


def test_embed_prefix_matches(model, batch):
    jc, tc, jp, tp = model
    je, jpad, jatt = jmvla.embed_prefix(jp, *(jnp.asarray(batch[k]) for k in INPUTS), jc, J32)
    te, tpad, tatt = tmvla.embed_prefix(tp, *(t_(batch[k]) for k in INPUTS), tc, T32)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    np.testing.assert_array_equal(tatt.numpy(), np.asarray(jatt))
    assert tatt[0, -tc.num_metaqueries:].tolist() == [1] + [0] * (tc.num_metaqueries - 1)


def test_compute_prompt_matches(model, batch):
    jprompt, tprompt = prompts(model, batch)
    assert tprompt.shape == jprompt.shape == (2, model[1].num_metaqueries, model[1].proj_width)
    assert rel(tprompt.numpy(), jprompt) <= RTOL


def test_expert_cached_and_direct_paths(model, batch):
    """The expert with the prompt and with its cached K/V: equal to each
    other within the port (the cross K/V are the same tensors), and each
    against the reference's velocity."""
    jc, tc, jp, tp = model
    jprompt, _ = prompts(model, batch)
    prompt = t_(jprompt)
    args = [t_(batch[k]) for k in ("state", "x_t", "time")]
    kv = tmvla.cache_prompt_kv(tp, prompt, tc, T32)
    direct = tmvla.predict_velocity(tp, prompt, *args, tc, T32)
    cached = tmvla.predict_velocity(tp, prompt, *args, tc, T32, prompt_kv=kv)
    np.testing.assert_allclose(cached.numpy(), direct.numpy(), rtol=2e-5, atol=2e-5)
    if tc.alternate_pattern == "self_cross":
        ck, cv = kv
        assert ck.shape == (tc.expert.depth // 2, 2, tc.num_metaqueries, tc.expert.num_kv_heads, tc.expert.head_dim)
        jk, jv = jexpert.prefill_prompt_kv(jp["expert"], jnp.asarray(jprompt), jc.expert, J32)
        assert rel(ck.numpy(), jk) <= RTOL and rel(cv.numpy(), jv) <= RTOL
    else:
        ck, cv = kv
        assert ck.shape == (tc.expert.depth, 2, tc.num_metaqueries, tc.expert.num_kv_heads, tc.expert.head_dim)
    ref = jax.jit(lambda p, pr, s, x, t: jmvla.predict_velocity(p, pr, s, x, t, jc, J32))(
        jp, jprompt, *(batch[k] for k in ("state", "x_t", "time")))
    assert direct.shape == (2, tc.chunk_size, tc.max_action_dim)
    assert rel(direct.numpy(), ref) <= RTOL and rel(cached.numpy(), ref) <= RTOL


def test_expert_forward_matches(batch):
    """expert.forward with the prompt and with prompt_kv against the
    reference's, on the suffix mask and positions predict_velocity builds."""
    from intact_tpu_torch.ops.masks import make_att_2d_masks

    jc, tc = cfg_pair()
    jp = jax.jit(jexpert.init, static_argnums=(1, 2))(jax.random.key(4), jc.expert, 16)
    tp = tcm.unflatten_paths({k: t_(v) for k, v in tcm.flatten_paths(jax.tree.map(np.asarray, jp)).items()})
    rng = np.random.default_rng(6)
    b, s = 2, 1 + tc.chunk_size
    suffix = rng.standard_normal((b, s, tc.expert.width), dtype=np.float32)
    prompt = rng.standard_normal((b, tc.num_metaqueries, 16), dtype=np.float32)
    pad = torch.ones((b, s), dtype=torch.bool)
    att = torch.zeros((b, s), dtype=torch.int32)
    att[:, :2] = 1
    mask, pos = make_att_2d_masks(pad, att), torch.arange(s)[None].expand(b, s)
    ref = jax.jit(lambda p, x, m, q, pr: jexpert.forward(p, x, m, q, jc.expert, prompt=pr, policy=J32,
                                                         attention_impl="pallas"))(
        jp, suffix, mask.numpy(), pos.numpy(), prompt)
    direct = texpert.forward(tp, t_(suffix), mask, pos, tc.expert, prompt=t_(prompt), policy=T32,
                             attention_impl="pallas")
    kv = texpert.prefill_prompt_kv(tp, t_(prompt), tc.expert, T32)
    cached = texpert.forward(tp, t_(suffix), mask, pos, tc.expert, prompt_kv=kv, policy=T32, attention_impl="pallas")
    assert torch.equal(direct, cached)
    assert rel(direct.numpy(), ref) <= RTOL


def test_forward_joint_one_pass_equals_cached(batch):
    """The joint expert's one [prompt | suffix] prefill against the cached
    prompt K/V and a suffix-only decode at positions P + i."""
    jc, tc = cfg_pair("joint")
    jp = jax.jit(jexpert.init_joint, static_argnums=1)(jax.random.key(5), jc.expert)
    tp = tcm.unflatten_paths({k: t_(v) for k, v in tcm.flatten_paths(jax.tree.map(np.asarray, jp)).items()})
    rng = np.random.default_rng(7)
    b, s = 2, 1 + tc.chunk_size
    suffix = rng.standard_normal((b, s, tc.expert.width), dtype=np.float32)
    prompt = rng.standard_normal((b, tc.num_metaqueries, tc.expert.width), dtype=np.float32)
    att = np.zeros((b, s), np.int32)
    att[:, :2] = 1
    with torch.no_grad():
        one = texpert.forward_joint(tp, t_(suffix), t_(prompt), t_(att), tc.expert, T32, "pallas")
        kv = texpert.prefill_joint_prompt_kv(tp, t_(prompt), tc.expert, T32, "pallas")
        cached = texpert.forward_joint(tp, t_(suffix), t_(prompt), t_(att), tc.expert, T32, "pallas", prompt_kv=kv)
    np.testing.assert_allclose(cached.numpy(), one.numpy(), rtol=2e-5, atol=2e-5)
    ref = jax.jit(lambda p, x, pr, a: jexpert.forward_joint(p, x, pr, a, jc.expert, J32, "pallas"))(
        jp, suffix, prompt, att)
    assert rel(one.numpy(), ref) <= RTOL and rel(cached.numpy(), ref) <= RTOL


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def jax_sample(jc, jp, batch):
    fn = jax.jit(lambda p, *a, noise: jmvla.sample_actions(p, jax.random.key(0), *a, jc, J32, noise=noise))
    return np.asarray(fn(jp, *(batch[k] for k in INPUTS + ("state",)), noise=batch["noise"]))


def test_sample_actions_matches(model, batch):
    jc, tc, jp, tp = model
    ref = jax_sample(jc, jp, batch)
    out = tmvla.sample_actions(tp, None, *(t_(batch[k]) for k in INPUTS + ("state",)), tc, T32,
                               noise=t_(batch["noise"]))
    assert out.shape == (2, tc.chunk_size, tc.max_action_dim) and out.dtype == torch.float32
    assert rel(out.numpy(), ref) <= RTOL


def test_int8_sample_actions_matches(model, batch):
    """int8 sampling on the reference's quantize_params tree against
    jax.jit of the reference's sampler on it."""
    jc, tc, jp, _ = model
    jq = jax.jit(jcm.quantize_params)(jp)
    tq = convert.from_jax_params(jax.tree.map(np.asarray, jq), tc, device="cpu")
    ref = jax_sample(jc, jq, batch)
    out = tmvla.sample_actions(tq, None, *(t_(batch[k]) for k in INPUTS + ("state",)), tc, T32,
                               noise=t_(batch["noise"])).numpy()
    assert rel(out, ref) <= 2e-2 and np.abs(out - ref).max() <= 0.1


# ---------------------------------------------------------------------------
# training: the loss and every leaf's gradient
# ---------------------------------------------------------------------------

def jax_draws(batch, jc):
    """The reference compute_loss's noise and time for jax.random.key(0)."""
    k_noise, k_time = jax.random.split(jax.random.key(0))
    shape = batch["actions"].shape
    return (np.asarray(jpi0.sample_noise(k_noise, shape)), np.asarray(jpi0.sample_time(k_time, shape[0], jc)))


@pytest.fixture(scope="module")
def jax_grads():
    """Loss, aux and gradients of the reference's self_cross model, once per
    value of its stop-gradient (train_expert_only and freeze_metaqueries):
    train_expert_only alone runs the same computation as the joint recipe."""
    cache = {}

    def get(jc, jp, jb):
        stop = jc.train_expert_only and jc.freeze_metaqueries
        if stop not in cache:
            cache[stop] = jax.jit(jax.value_and_grad(
                lambda p, b: jmvla.compute_loss(p, jax.random.key(0), b, jc, J32), has_aux=True))(jp, jb)
        return cache[stop]

    return get


@pytest.mark.parametrize("recipe", ["joint", "expert_only", "freeze_metaqueries"])
def test_loss_and_gradients_match(batch, jax_grads, recipe):
    """Every leaf's gradient of the self_cross model: the joint recipe
    (everything trains); train_expert_only (the same loss path: the
    metaqueries get their gradient through the frozen VLM); and
    freeze_metaqueries, where the prompt's backward stops at the connector
    (no gradient reaches the metaqueries, the VLM or SigLIP)."""
    jc, tc, jp, tp = build("self_cross")
    kw = {"joint": {}, "expert_only": {"train_expert_only": True},
          "freeze_metaqueries": {"train_expert_only": True, "freeze_metaqueries": True}}[recipe]
    jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    jb = {k: jnp.asarray(batch[k]) for k in INPUTS + ("state", "actions", "action_is_pad")}
    (jl, jaux), jg = jax_grads(jc, jp, jb)
    noise, time = jax_draws(batch, jc)

    flat = tcm.flatten_paths(tp)
    views = {k: v.detach().clone().requires_grad_() for k, v in flat.items()}
    loss, aux = tmvla.compute_loss(tcm.unflatten_paths(views), None, {k: t_(v) for k, v in jb.items()}, tc, T32,
                                   noise=t_(noise), time=t_(time))
    grads = dict(zip(views, torch.autograd.grad(loss, list(views.values()), allow_unused=True,
                                                materialize_grads=True)))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert rel(aux["losses"].detach().numpy(), jaux["losses"]) <= RTOL
    jflat = tcm.flatten_paths(jax.tree.map(np.asarray, jg))
    assert jflat.keys() == grads.keys()
    shift = [k for k in jflat if k.endswith("attn/k/bias")]  # exact gradient 0: the softmax cancels it
    total = np.sqrt(sum(np.square(g).sum() for g in jflat.values()))
    assert shift and all(max(np.linalg.norm(jflat[k]), grads[k].norm().item()) <= 1e-6 * total for k in shift)
    cut = ("siglip", "img_proj", "vlm_embed", "vlm", "metaquery") if recipe == "freeze_metaqueries" else ()
    for k in jflat:
        if k.startswith(cut):
            assert not np.any(jflat[k]) and not grads[k].any(), k
        elif k not in shift:
            assert rel(grads[k].numpy(), jflat[k]) <= RTOL, k
    assert (np.abs(jflat["metaquery"]).sum() > 0) == (recipe != "freeze_metaqueries")
    assert np.abs(jflat["connector/blocks/mlp/up/kernel"]).sum() > 0


# ---------------------------------------------------------------------------
# the DiT head and the diffusion samplers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dit_model():
    """A tiny DiT with its zero-initialised adaLN and output leaves drawn at
    random, so that every block reaches the output."""
    dcfg = jdit.tiny_test_config()
    jp = jax.tree.map(np.asarray, jax.jit(jdit.init, static_argnums=1)(jax.random.key(0), dcfg))
    rng = np.random.default_rng(8)
    flat = {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.05 if not np.any(v) else v)
            for k, v in tcm.flatten_paths(jp).items()}
    jp = tcm.unflatten_paths(flat)
    tp = tcm.unflatten_paths({k: t_(v) for k, v in flat.items()})
    return dcfg, tdit.tiny_test_config(), jax.tree.map(jnp.asarray, jp), tp


def test_dit_apply_matches(dit_model):
    jc, tc, jp, tp = dit_model
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, tc.horizon, tc.action_dim), dtype=np.float32)
    t = np.array([0, 41, 99], np.int32)
    cond = rng.standard_normal((3, tc.cond_dim), dtype=np.float32)
    ref = jax.jit(lambda p, *a: jdit.apply(p, *a, jc, J32))(jp, x, t, cond)
    out = tdit.apply(tp, t_(x), t_(t), t_(cond), tc, T32)
    assert out.shape == (3, tc.horizon, tc.action_dim)
    assert rel(out.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("kind", ["squaredcos_cap_v2", "linear"])
def test_ddim_sample_and_training_loss_match(dit_model, kind):
    """ddim_sample from a given x_T with eta=0 (deterministic) through the
    DiT, q_sample and the training loss with given timesteps and noise, and
    the schedules' alphas_cumprod."""
    jc, tc, jp, tp = dit_model
    js, ts = jdiff.make_schedule(50, kind), tdiff.make_schedule(50, kind)
    assert ts.betas == js.betas
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod), rtol=1e-6)
    rng = np.random.default_rng(10)
    shape = (2, tc.horizon, tc.action_dim)
    x_T = rng.standard_normal(shape, dtype=np.float32)
    cond = rng.standard_normal((2, tc.cond_dim), dtype=np.float32)
    ref = jax.jit(lambda p, x, c: jdiff.ddim_sample(
        js, lambda xt, ti, cc: jdit.apply(p, xt, ti, cc, jc, J32), jax.random.key(0), shape, c, num_steps=5,
        eta=0.0, init_noise=x))(jp, x_T, cond)
    out = tdiff.ddim_sample(ts, lambda xt, ti, cc: tdit.apply(tp, xt, ti, cc, tc, T32), None, shape, t_(cond),
                            num_steps=5, eta=0.0, init_noise=t_(x_T))
    assert rel(out.numpy(), ref) <= 1e-5

    x0 = rng.uniform(-1, 1, shape).astype(np.float32)
    t_int = np.array([3, 47], np.int32)
    noise = rng.standard_normal(shape, dtype=np.float32)
    assert rel(tdiff.q_sample(ts, t_(x0), t_(t_int), t_(noise)).numpy(),
               jdiff.q_sample(js, jnp.asarray(x0), jnp.asarray(t_int), jnp.asarray(noise))) <= 1e-6
    loss, aux = tdiff.training_loss(ts, lambda xt, ti, cc: tdit.apply(tp, xt, ti, cc, tc, T32), None, t_(x0),
                                    t_(cond), t_int=t_(t_int), noise=t_(noise))
    eps = jdit.apply(jp, jdiff.q_sample(js, jnp.asarray(x0), jnp.asarray(t_int), jnp.asarray(noise)),
                     jnp.asarray(t_int), jnp.asarray(cond), jc, J32)
    assert abs(loss.item() - float(jnp.square(eps - noise).mean())) <= 1e-5 * loss.item()
    assert aux["losses"].shape == shape


def test_ddpm_and_eta_sampling_run():
    """ddpm_sample and DDIM with eta > 0 draw from the generator: the same
    seed gives the same sample, and clip_value bounds it."""
    ts = tdiff.make_schedule(20)
    shape = (2, 4, 3)

    def eps(x, t, c):
        return 0.1 * x

    a = tdiff.ddpm_sample(ts, eps, torch.Generator().manual_seed(0), shape, clip_value=1.0)
    b = tdiff.ddpm_sample(ts, eps, torch.Generator().manual_seed(0), shape, clip_value=1.0)
    assert torch.equal(a, b) and a.abs().max() <= 1.0
    c = tdiff.ddim_sample(ts, eps, torch.Generator().manual_seed(1), shape, num_steps=4, eta=1.0)
    assert torch.isfinite(c).all() and c.shape == shape
    emb = tdiff.timestep_embedding(torch.tensor([0, 7]), 9)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jdiff.timestep_embedding(jnp.array([0, 7]), 9)),
                               rtol=1e-6, atol=1e-6)


def test_dit_head_samples_and_trains(batch):
    """action_head="dit": the reference's sampler from x_T = the given noise
    (ddim_sample with init_noise over its compute_prompt) against the port's
    sample_actions; the port's epsilon loss, drawn from a numpy Generator
    (training_loss itself is held above)."""
    base = build("self_cross")
    jc, tc = cfg_pair(action_head="dit", dit_width=32, dit_depth=2, dit_heads=2, diffusion_steps=20)
    rng = np.random.default_rng(11)
    dit = tcm.flatten_paths({"dit": jax.tree.map(np.asarray, jax.jit(jdit.init, static_argnums=1)(
        jax.random.key(1), jmvla._dit_config(jc)))})
    dit = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.05 if not np.any(v) else v for k, v in dit.items()}
    shared = {k: v for k, v in tcm.flatten_paths(jax.tree.map(np.asarray, base[2])).items()
              if k.split("/")[0] in ("siglip", "img_proj", "vlm_embed", "vlm", "metaquery", "connector")}
    tree = tcm.unflatten_paths({**shared, **dit})
    jp, tp = jax.tree.map(jnp.asarray, tree), convert.from_jax_params(tree, tc, device="cpu")
    assert "dit" in tp and "expert" not in tp
    prompt, _ = prompts(base, batch)  # the same prefix and connector weights
    ref = jax.jit(lambda p, c, x: jdiff.ddim_sample(
        jdiff.make_schedule(jc.diffusion_steps), jmvla._dit_eps_fn(p, jc, J32), jax.random.key(0), x.shape, c,
        num_steps=jc.num_steps, init_noise=x))(jp, prompt.mean(axis=1), batch["noise"])
    out = tmvla.sample_actions(tp, None, *(t_(batch[k]) for k in INPUTS + ("state",)), tc, T32,
                               noise=t_(batch["noise"]))
    assert rel(out.numpy(), ref) <= RTOL

    b = {k: t_(batch[k]) for k in INPUTS + ("state", "actions")}
    loss, aux = tmvla.compute_loss(tp, np.random.default_rng(0), b, tc, T32)
    assert torch.isfinite(loss) and aux["losses"].shape == batch["actions"].shape
