"""The port's standard (unfused) training step and its trainer, on the CPU.

The model pieces run `Pi0Config.tiny()` in fp32 in both packages, on
parameters made by the JAX `pi0.init` and carried across by
`intact_tpu_torch.convert`; inputs come from a seeded numpy generator and the
flow noise and time are the JAX draws, fed to the port. The int8 JAX side runs
compiled (`jax.jit`), whose products the port reproduces. Tolerances, each
with its reason:
  * velocities 1e-5, losses and norms 1e-5 relative: fp32 matmuls and
    reductions summed in another order;
  * gradients 2e-4 relative plus 1e-6 absolute (as the JAX package's own
    frozen-prefix test), or 1e-4 of the leaf's largest entry against JAX;
  * parameters after one Adam step (lr 1e-3): 2e-4 relative plus 1e-4
    absolute, because Adam's first step moves an element by ~lr whatever its
    gradient's size, so a gradient near rounding noise moves its element by
    a visible fraction of lr;
  * int8 codes, scales and frozen leaves: bit-equal.
The trainer runs the repo's recipes at `tiny()` with `mesh.fsdp=1`: its
counters, checkpoints and resumed runs are compared bit for bit.
"""

import dataclasses
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intact_tpu.models import common as jcm
from intact_tpu.models.pi0 import model as jpi0
from intact_tpu.models.pi0.config import Pi0Config as JPi0Config
from intact_tpu.train.optim import OptimizerConfig as JOpt
from intact_tpu.train.optim import make_optimizer as j_make_optimizer
from intact_tpu.train.train_step import init_train_state as j_init_state
from intact_tpu.train.train_step import make_train_step as j_make_step
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models.pi0 import model as tpi0
from intact_tpu_torch.models.pi0.config import Pi0Config as TPi0Config
from intact_tpu_torch.train import checkpoint as ckpt
from intact_tpu_torch.train import train_step as tts
from intact_tpu_torch.train.optim import OptimizerConfig as TOpt
from intact_tpu_torch.train.optim import make_optimizer as t_make_optimizer

REPO = Path(__file__).resolve().parent.parent
J32 = jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
T32 = tcm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
OPT_KW = dict(lr=1e-3, weight_decay=1e-4, warmup_steps=2, first_cycle_steps=100)
FROZEN = ("siglip", "img_proj", "vlm", "vlm_embed")  # train_expert_only's frozen set
TRAINED = ("expert", "state_proj", "action_in_proj", "time_mlp_in", "time_mlp_out", "action_out_proj")


@pytest.fixture(scope="module")
def cfgs():
    return (dataclasses.replace(JPi0Config.tiny(), train_expert_only=True),
            dataclasses.replace(TPi0Config.tiny(), train_expert_only=True))


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jax.jit(jpi0.init, static_argnums=1)(jax.random.key(0), cfgs[0])


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
    lang_masks[1, :3] = True
    action_is_pad = np.zeros((b, cfg.chunk_size), bool)
    action_is_pad[1, -1] = True
    return {
        "images": rng.uniform(-1, 1, (b, cfg.num_cameras, s, s, 3)).astype(np.float32),
        "img_masks": np.ones((b, cfg.num_cameras), bool),
        "lang_tokens": rng.integers(0, 256, (b, cfg.tokenizer_max_length)).astype(np.int32),
        "lang_masks": lang_masks,
        "state": rng.standard_normal((b, cfg.max_state_dim), dtype=np.float32),
        "actions": rng.standard_normal((b, cfg.chunk_size, cfg.max_action_dim), dtype=np.float32),
        "action_is_pad": action_is_pad,
    }


def t_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def j_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def jax_flow_draws(key, cfg, actions_shape):
    """The noise and time compute_loss draws from `key`."""
    k_noise, k_time = jax.random.split(key)
    return (np.array(jpi0.sample_noise(k_noise, actions_shape)),
            np.array(jpi0.sample_time(k_time, actions_shape[0], cfg)))


# ---------------------------------------------------------------------------
# the frozen-prefix path
# ---------------------------------------------------------------------------

def test_frozen_prefix_velocity_matches_jax_and_the_joint_path(cfgs, jparams, tparams, batch):
    rng = np.random.default_rng(3)
    x_t = rng.standard_normal((2, cfgs[0].chunk_size, cfgs[0].max_action_dim)).astype(np.float32)
    time = np.array([0.3, 0.8], np.float32)
    names = ("images", "img_masks", "lang_tokens", "lang_masks", "state")
    want = jpi0.predict_velocity_frozen_prefix(jparams, *(jnp.asarray(batch[k]) for k in names), jnp.asarray(x_t),
                                               jnp.asarray(time), cfgs[0], J32)
    args = (*(torch.from_numpy(batch[k]) for k in names), torch.from_numpy(x_t), torch.from_numpy(time), cfgs[1], T32)
    got = tpi0.predict_velocity_frozen_prefix(tparams, *args)
    joint = tpi0.predict_velocity(tparams, *args)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), joint.detach().numpy(), rtol=1e-5, atol=1e-5)


def test_frozen_prefix_grads_match_jax_and_the_joint_path(cfgs, jparams, tparams, batch):
    """Expert and head gradients through the frozen prefix equal JAX's and the
    port's joint path's; the frozen tower gets none."""
    key = jax.random.key(2)
    g_jax = jax.jit(jax.grad(lambda p: jpi0.compute_loss(p, key, j_batch(batch), cfgs[0], J32)[0]))(jparams)
    noise, time = (torch.from_numpy(x) for x in jax_flow_draws(key, cfgs[0], batch["actions"].shape))
    grads = {}
    for name, train in (("frozen", True), ("joint", False)):
        leaves = tcm.tree_map(lambda t: t.detach().clone().requires_grad_(), tparams)
        loss, _ = tpi0.compute_loss(leaves, None, t_batch(batch), cfgs[1], T32, train=train, noise=noise, time=time)
        loss.backward()
        grads[name] = {k: v.grad for k, v in tcm.flatten_paths(leaves).items()}
    want = {k: np.asarray(v) for k, v in tcm.flatten_paths(jax.tree.map(np.asarray, g_jax)).items()}
    for k, g in grads["frozen"].items():
        if k.split("/")[0] in FROZEN:
            assert g is None, k  # no graph through the prefix
            continue
        scale = max(np.abs(want[k]).max(), 1e-30)
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4, atol=1e-4 * scale, err_msg=k)
        np.testing.assert_allclose(g.numpy(), grads["joint"][k].numpy(), rtol=2e-4, atol=1e-6, err_msg=k)


def test_quantize_frozen_matches_jax(cfgs, jparams, tparams):
    """Only the wholly frozen dense nodes of the default pattern become int8,
    with the codes and scales of the compiled reference (transposed)."""
    jmask = jax.tree.map(lambda _: True, jparams)
    for name in FROZEN:
        jmask[name] = jax.tree.map(lambda _: False, jparams[name])
    jq = jax.jit(lambda p: jcm.quantize_frozen(p, jmask))(jparams)
    want = tcm.flatten_paths(convert.from_jax_params(jax.tree.map(np.asarray, jq), cfgs[1], device="cpu"))
    tmask = tcm.tree_map(lambda _: True, tparams)
    for name in FROZEN:
        tmask[name] = tcm.tree_map(lambda _: False, tparams[name])
    got = tcm.flatten_paths(tcm.quantize_frozen(tparams, tmask))
    assert set(got) == set(want)
    quantized = {k for k in got if k.endswith("kernel_q")}
    assert quantized and all(k.split("/")[0] in ("siglip", "img_proj", "vlm") for k in quantized)
    assert "expert/blocks/mlp/up/kernel" in got and "siglip/patch_embed/kernel" not in quantized
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_expert_only_train_step_matches_jax(cfgs, jparams, batch):
    """One standard step of the expert-only recipe over a quantized frozen
    tower (AdamW, clip, freeze partition), same noise and time."""
    jmask = jax.tree.map(lambda _: True, jparams)
    for name in FROZEN:
        jmask[name] = jax.tree.map(lambda _: False, jparams[name])
    jq = jax.jit(lambda p: jcm.quantize_frozen(p, jmask))(jparams)
    jmask_q = {name: jax.tree.map(lambda _: name not in FROZEN, sub) for name, sub in jq.items()}
    jtx, _ = j_make_optimizer(JOpt(**OPT_KW), jmask_q)
    jstate = j_init_state(jq, jtx, seed=0)
    jstep = jax.jit(j_make_step(lambda p, k, b: jpi0.compute_loss(p, k, b, cfgs[0], J32), jtx, J32,
                                trainable_mask=jmask_q))
    jnew, jmetrics = jstep(jstate, j_batch(batch))
    noise, time = jax_flow_draws(jax.random.split(jstate.rng, 3)[1], cfgs[0], batch["actions"].shape)

    tq = convert.from_jax_params(jax.tree.map(np.asarray, jq), cfgs[1], device="cpu")
    before = {k: v.clone() for k, v in tcm.flatten_paths(tq).items()}
    tmask = {name: tcm.tree_map(lambda _: name not in FROZEN, sub) for name, sub in tq.items()}
    ttx, _ = t_make_optimizer(TOpt(**OPT_KW), tmask)
    tstate = tts.init_train_state(tq, ttx, seed=0)
    tstep = tts.make_train_step(
        lambda p, rng, b, n, t: tpi0.compute_loss(p, rng, b, cfgs[1], T32, noise=n, time=t), ttx)
    tstate, tmetrics = tstep(tstate, t_batch(batch), noise=torch.from_numpy(noise), time=torch.from_numpy(time))
    assert tstate.step == 1 and tstate.opt_state["count"] == 1
    assert set(tstate.opt_state["mu"]) == {k for k in before if k.split("/")[0] in TRAINED}
    for k in ("l2_loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose(tmetrics[k].item(), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    want = {k: np.asarray(v) for k, v in tcm.flatten_paths(jax.tree.map(np.asarray, jnew.params)).items()}
    want = {k: np.swapaxes(v, -1, -2) if k.endswith("kernel_q") else v for k, v in want.items()}
    for k, v in tcm.flatten_paths(tstate.params).items():
        if k.split("/")[0] in FROZEN:
            assert torch.equal(v, before[k]), k
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want[k], rtol=2e-4, atol=1e-4, err_msg=k)
    assert not torch.equal(tstate.params["expert"]["blocks"]["mlp"]["up"]["kernel"],
                           before["expert/blocks/mlp/up/kernel"])


def test_param_norm_is_taken_after_the_update(cfgs, jparams, batch):
    """At lr 0.5 one Adam step moves each trained element by ~0.5, so the
    params' norm before the update lies far from the norm after it; the
    port's param_norm is the JAX step's, after the update."""
    opt = {**OPT_KW, "lr": 0.5, "warmup_steps": 0}
    jmask = {name: jax.tree.map(lambda _: name not in FROZEN, sub) for name, sub in jparams.items()}
    jtx, _ = j_make_optimizer(JOpt(**opt), jmask)
    jstate = j_init_state(jparams, jtx, seed=0)
    jstep = jax.jit(j_make_step(lambda p, k, b: jpi0.compute_loss(p, k, b, cfgs[0], J32), jtx, J32,
                                trainable_mask=jmask))
    _, jmetrics = jstep(jstate, j_batch(batch))
    noise, time = jax_flow_draws(jax.random.split(jstate.rng, 3)[1], cfgs[0], batch["actions"].shape)

    tp = convert.from_jax_params(jax.tree.map(np.asarray, jparams), cfgs[1], device="cpu")
    before = float(torch.sqrt(sum(torch.square(v).sum() for v in tcm.flatten_paths(tp).values())))
    tmask = {name: tcm.tree_map(lambda _: name not in FROZEN, sub) for name, sub in tp.items()}
    ttx, _ = t_make_optimizer(TOpt(**opt), tmask)
    tstep = tts.make_train_step(
        lambda p, rng, b, n, t: tpi0.compute_loss(p, rng, b, cfgs[1], T32, noise=n, time=t), ttx)
    _, tmetrics = tstep(tts.init_train_state(tp, ttx, seed=0), t_batch(batch), noise=torch.from_numpy(noise),
                        time=torch.from_numpy(time))
    want = float(jmetrics["param_norm"])
    assert abs(before - want) > 1e-2 * want
    np.testing.assert_allclose(tmetrics["param_norm"].item(), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the trainer on the repo's recipes
# ---------------------------------------------------------------------------

RECIPES = {
    "expertonly": "config/train/pi0_finetune_bridge_expertonly.yaml",
    "joint": "config/train/pi0_finetune_bridge.yaml",
    "fused": "config/train/pi0_finetune_bridge_1chip.yaml",
}


@pytest.fixture
def make_cfg(monkeypatch, tmp_path):
    """recipe name + overrides -> TrainPipelineConfig at tiny() (the model
    JSON's train_expert_only kept), one card, micro batch 2, accumulation 2
    (the fused recipe: 1), logging every update, under tmp_path. 8-bit
    moments quantize leaves from 1024 elements, so tiny() has some."""
    from intact_tpu_torch import run
    from intact_tpu_torch.config import pipeline
    from intact_tpu_torch.train import optim8bit

    monkeypatch.setattr(optim8bit, "MIN_QUANT_ELEMS", 1024)

    monkeypatch.setattr(pipeline, "pi0_config_from_json", lambda d: dataclasses.replace(
        TPi0Config.tiny(), train_expert_only=bool(d.get("train_expert_only", False))))

    def make(recipe: str, **overrides):
        kw = {"mesh.fsdp": 1, "per_device_batch_size": 2, "global_batch_size": 2 if recipe == "fused" else 4,
              "n_updates": 2, "log_freq": 1, "eval_size": 2, "tokenizer_path": "hash", "log_dir": tmp_path}
        kw.update(overrides)
        argv = ["--config_path", str(REPO / RECIPES[recipe])]
        for k, v in kw.items():
            argv += [f"--{k}", str(v)]
        return run.build_config(argv)[0]

    return make


def state_items(state) -> dict:
    """Every tensor and number of a training state, by path."""
    out = {}
    for name, value in ckpt.state_fields(state).items():
        out.update({f"{name}/{k}": v for k, v in tcm.flatten_paths({"": value} if not isinstance(value, dict)
                                                                   else value).items()})
    out.update({f"params/{k}": v for k, v in tcm.flatten_paths(state.params).items()})
    return out


def assert_states_equal(a, b):
    ia, ib = state_items(a), state_items(b)
    assert set(ia) == set(ib)
    for k, v in ia.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == ib[k].dtype and torch.equal(v, ib[k]), k
        else:
            assert v == ib[k], k


@pytest.mark.parametrize("recipe", ["expertonly", "joint"])
def test_recipe_trains_validates_and_saves_its_last_update(make_cfg, recipe, caplog):
    """n_updates 3 with save_model_freq 2 writes step_2 and the last update's
    step_3; validation at eval_freq 3; accumulation 2 counts 6 micro-steps and
    3 updates; frozen leaves bit-unchanged, trained ones moved."""
    from intact_tpu_torch.train.trainer import Trainer

    trainer = Trainer(make_cfg(recipe, n_updates=3, save_model_freq=2, eval_freq=3), device="cpu")
    params = tcm.flatten_paths(trainer.state.params)
    before = {k: v.clone() for k, v in params.items()}
    if recipe == "expertonly":  # frozen int8 tower, fp32 expert masters, AdamW
        assert params["vlm/blocks/mlp/up/kernel_q"].dtype == torch.int8
        assert params["expert/blocks/mlp/up/kernel"].dtype == torch.float32
        assert params["vlm_embed/embedding"].dtype == torch.bfloat16
    else:  # bf16 masters, 8-bit moments, remat
        assert {v.dtype for v in params.values()} == {torch.bfloat16} and trainer.bf16_masters
        assert trainer.cfg.remat and trainer.opt_cfg.quantize_moments
    with caplog.at_level(logging.INFO, logger="intact_tpu_torch.trainer"):
        trainer.train()
    assert trainer.cnt_update == 3 and trainer.state.step == 6
    assert trainer.state.opt_state["count"] == trainer.state.opt_state["gradient_step"] == 3
    assert ckpt.list_steps(trainer.ckpt_root, committed_only=True) == [2, 3]
    val = [r.getMessage() for r in caplog.records if r.getMessage().startswith("val @ update")]
    assert len(val) == 1 and "val @ update 3" in val[0] and "l1_loss" in val[0] and val[0].count("acc@") == 5
    trained = 0
    for k, v in tcm.flatten_paths(trainer.state.params).items():
        frozen = k.split("/")[0] in (FROZEN if recipe == "expertonly" else ("vlm_embed",))
        if frozen:
            assert torch.equal(v, before[k]), k
        trained += not torch.equal(v, before[k])
    assert trained > 10
    if recipe == "joint":
        assert trainer.state.opt_state["mu"]["vlm/blocks/mlp/up/kernel"]["q"].dtype == torch.int8


def test_validate_runs_at_every_eval_freq(make_cfg, caplog):
    from intact_tpu_torch.train.trainer import Trainer

    trainer = Trainer(make_cfg("expertonly", eval_freq=1, eval_size=4), device="cpu")
    with caplog.at_level(logging.INFO, logger="intact_tpu_torch.trainer"):
        trainer.train()
    val = [r.getMessage() for r in caplog.records if r.getMessage().startswith("val @ update")]
    assert [v.split("|")[0].strip() for v in val] == ["val @ update 1", "val @ update 2"]
    metrics = trainer.validate()
    assert list(metrics) == ["l1_loss"] + [f"acc@{t}" for t in trainer.cfg.eval_thresholds]
    assert np.isfinite(metrics["l1_loss"]) and all(0.0 <= metrics[f"acc@{t}"] <= 1.0 for t in (0.05, 0.5))


def test_accumulation_counts_updates_only_on_emit(make_cfg):
    from intact_tpu_torch.train.trainer import Trainer

    trainer = Trainer(make_cfg("expertonly", global_batch_size=6, n_updates=2, save_model_freq=1), device="cpu")
    assert trainer.opt_cfg.grad_accumulation_steps == 3
    seen = []
    step = trainer.train_step

    def counting(state, b):
        seen.append((trainer.cnt_update, state.opt_state["count"]))
        return step(state, b)

    trainer.train_step = counting
    trainer.train()
    assert seen == [(0, 0), (0, 0), (0, 0), (1, 1), (1, 1), (1, 1)]
    assert trainer.cnt_update == 2 and trainer.state.step == 6
    assert ckpt.list_steps(trainer.ckpt_root, committed_only=True) == [1, 2]


@pytest.mark.parametrize("recipe", ["expertonly", "joint", "fused"])
def test_resumed_run_continues_bit_for_bit(make_cfg, recipe):
    """A run resumed from its step_2 takes the same next step as the run that
    saved it: params, optimizer state, counters and random draws."""
    from intact_tpu_torch.train.trainer import Trainer

    first = Trainer(make_cfg(recipe), device="cpu")
    first.train()
    step_dir = first.ckpt_root / "step_2"
    resumed = Trainer(make_cfg(recipe, load_from_checkpoint=step_dir), device="cpu")
    assert resumed.cnt_update == 2
    assert_states_equal(resumed.state, first.state)
    b = first.device_batch(next(iter(first.train_data)))
    s1, m1 = first.train_step(first.state, b)
    s2, m2 = resumed.train_step(resumed.state, b)
    assert_states_equal(s2, s1)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)


def test_params_only_load_resets_the_run(make_cfg):
    from intact_tpu_torch.train.trainer import Trainer

    first = Trainer(make_cfg("joint"), device="cpu")
    first.train()
    fresh = Trainer(make_cfg("joint"), device="cpu")
    loaded = Trainer(make_cfg("joint", load_from_checkpoint=first.ckpt_root, resume_run="false"), device="cpu")
    assert loaded.cnt_update == 0 and loaded.state.step == 0 and loaded.state.opt_state["count"] == 0
    for k, v in tcm.flatten_paths(first.state.params).items():
        assert torch.equal(tcm.flatten_paths(loaded.state.params)[k], v), k
    for k, v in state_items(fresh.state).items():
        if not k.startswith("params/"):
            got = state_items(loaded.state)[k]
            assert torch.equal(got, v) if isinstance(v, torch.Tensor) else got == v, k


def test_quantize_frozen_fine_tune_loads_float_params(make_cfg, tmp_path):
    """quantize_frozen_int8 with resume_run false: a float checkpoint loads
    into the float template (frozen leaves bf16) and the frozen tower is
    quantized from it."""
    from intact_tpu_torch.train.trainer import Trainer

    saved = tpi0.init(TPi0Config.tiny(), seed=7, device="cpu")
    ckpt.save_checkpoint(tmp_path / "pretrained", saved, step=5)
    trainer = Trainer(make_cfg("expertonly", load_from_checkpoint=tmp_path / "pretrained", resume_run="false"),
                      device="cpu")
    assert trainer.cnt_update == 0
    mask = tcm.tree_map(lambda _: True, saved)
    for name in FROZEN:
        mask[name] = tcm.tree_map(lambda _: False, saved[name])
        saved[name] = tcm.tree_map(lambda x: x.to(torch.bfloat16), saved[name])
    want = tcm.flatten_paths(tcm.quantize_frozen(saved, mask))
    got = tcm.flatten_paths(trainer.state.params)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("recipe", ["expertonly", "fused"])
def test_trainer_is_freed_on_del(make_cfg, recipe):
    """No reference cycle through the trainer's step: dropping the trainer
    frees its parameters and optimizer state at once (a full-tower state is
    tens of GB on the card)."""
    import weakref

    from intact_tpu_torch.train.trainer import Trainer

    trainer = Trainer(make_cfg(recipe), device="cpu")
    ref = weakref.ref(trainer)
    del trainer
    assert ref() is None


@pytest.mark.parametrize("recipe,overrides,error", [
    ("joint", {"quantize_frozen_int8": "true"}, "quantize_frozen_int8 requires"),
    ("fused", {"model_cfg.train_expert_only": "true"}, "standard path for expert-only"),
    # the repo's fsdp 4 mesh in a single process: the world of one rank does not fill it
    pytest.param("expertonly", {"mesh.fsdp": 4}, r"1 devices not divisible by fsdp\*tensor=4",
                 id="expertonly-overrides2-meshes"),
    ("expertonly", {"global_batch_size": 5}, "not a multiple"),
    pytest.param("joint", {"mesh.tensor": 2, "fused_update": "true"}, "the tensor axis", id="joint-tensor-axis"),
])
def test_refusals(make_cfg, recipe, overrides, error):
    from intact_tpu_torch.train.trainer import Trainer

    with pytest.raises((ValueError, NotImplementedError), match=error):
        Trainer(make_cfg(recipe, **overrides), device="cpu")


@pytest.mark.parametrize("freeze_metaqueries", [False, True])
def test_mvla_trains_through_the_standard_step(make_cfg, monkeypatch, freeze_metaqueries):
    """A tiny mvla (train_expert_only) runs the joint recipe's standard step
    (bf16 masters, 8-bit moments, remat) for two updates through the Trainer.
    The freeze set is the reference's: SigLIP, the projector, the VLM and its
    embedding, and the metaqueries only under freeze_metaqueries (otherwise
    they train through the frozen VLM). Frozen leaves stay bit-equal, the
    metaqueries, the connector and the expert move; quantize_frozen_int8 is
    refused (the metaqueries' gradient passes through the frozen tower)."""
    from intact_tpu_torch.models import registry
    from intact_tpu_torch.models.mvla.config import MVLAConfig
    from intact_tpu_torch.train.trainer import Trainer

    mc = dataclasses.replace(MVLAConfig.tiny(), train_expert_only=True, freeze_metaqueries=freeze_metaqueries)
    monkeypatch.setitem(registry.get("mvla_tiny"), "default_config", lambda: mc)
    with pytest.raises(ValueError, match="quantize_frozen_int8 requires"):
        Trainer(make_cfg("joint", **{"model_cfg.type": "mvla_tiny", "quantize_frozen_int8": "true"}), device="cpu")
    # lr 1e-2 from the first update: every trainable element moves by far more
    # than a bf16 ulp, so which leaves move does not hang on stochastic rounding
    trainer = Trainer(make_cfg("joint", **{"model_cfg.type": "mvla_tiny", "model_cfg.optimizer_lr": 1e-2,
                                           "model_cfg.scheduler_warmup_steps": 0}), device="cpu")
    frozen = {k for k, t in tcm.flatten_paths(trainer.frozen_mask).items() if not t}
    want = ("siglip/", "img_proj/", "vlm/", "vlm_embed/") + (("metaquery",) if freeze_metaqueries else ())
    assert frozen == {k for k in tcm.flatten_paths(trainer.state.params) if k.startswith(want)}
    before = {k: v.clone() for k, v in tcm.flatten_paths(trainer.state.params).items()}
    trainer.train()
    assert trainer.cnt_update == 2 and trainer.state.step == 4
    after = tcm.flatten_paths(trainer.state.params)
    assert all(torch.equal(after[k], before[k]) for k in frozen)
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    assert moved == set(after) - frozen
    assert ("metaquery" in moved) == (not freeze_metaqueries)
    assert {"connector/blocks/mlp/up/kernel", "expert/pairs/cross/attn/k/kernel"} <= moved
