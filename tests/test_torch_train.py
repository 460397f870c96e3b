"""The PyTorch port's training slice against the JAX package's, on the CPU.

Both packages run `Pi0Config.tiny()` in fp32 on parameters made by the JAX
`pi0.init` and carried across by `intact_tpu_torch.convert`; inputs come from
a seeded numpy generator, and the flow noise and time are the JAX draws, fed
to the port. Tolerances, each with its reason:
  * losses 1e-5 relative, gradients 1e-4 of the leaf's largest entry: fp32
    matmuls and reductions summed in another order;
  * the fused step's parameters after two Adam steps (lr 1e-3): 2e-4 relative
    plus 1e-4 absolute, because Adam's first steps move an element by ~lr
    whatever the gradient's size, so a gradient near rounding noise moves its
    element by a visible fraction of lr; scales and fp32 moments 1e-4 of the
    leaf's largest entry (the gradients' tolerance); fp8 codes equal on at
    least 99% of each leaf's elements (all but one in the smallest), the rest
    a rounding boundary apart (decoded values within two code steps of the
    row's top binade).
    SigLIP's key bias is left out: softmax ignores a bias added to every key,
    so its gradient is pure rounding noise in both packages;
  * grad_norm 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intact_tpu.models import common as jcm
from intact_tpu.models import gemma as jgemma
from intact_tpu.models.pi0 import model as jpi0
from intact_tpu.models.pi0.config import Pi0Config as JPi0Config
from intact_tpu.ops import attention as jattn
from intact_tpu.ops import pallas_adam
from intact_tpu.ops.masks import make_att_2d_masks as j_masks
from intact_tpu.train import fused_joint as jfj
from intact_tpu.train.optim import OptimizerConfig as JOpt
from intact_tpu.train.optim import cosine_warmup_restarts as j_schedule
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models import gemma as tgemma
from intact_tpu_torch.models.pi0 import model as tpi0
from intact_tpu_torch.models.pi0.config import Pi0Config as TPi0Config
from intact_tpu_torch.ops import attention as tattn
from intact_tpu_torch.ops.flash_attention import flash_attention_reference
from intact_tpu_torch.train import fused_joint as tfj
from intact_tpu_torch.train.optim import OptimizerConfig as TOpt
from intact_tpu_torch.train.optim import cosine_warmup_restarts as t_schedule

J32 = jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
T32 = tcm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
OPT_KW = dict(lr=1e-3, weight_decay=1e-4, warmup_steps=2, first_cycle_steps=100, max_grad_norm=1e9)
FUSED_KW = dict(block_size=8, stochastic_rounding=False, scale_mode="exact")
STRUCTURALLY_ZERO = {"siglip/blocks/attn/k/bias"}


@pytest.fixture(scope="module")
def cfgs():
    return JPi0Config.tiny(), TPi0Config.tiny()


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


def jax_flow_draws(key, cfg, actions_shape):
    """The noise and time compute_loss / the fused step draw from `key`."""
    k_noise, k_time = jax.random.split(key)
    noise = np.array(jpi0.sample_noise(k_noise, actions_shape))
    return noise, np.array(jpi0.sample_time(k_time, actions_shape[0], cfg))


def flat(tree) -> dict:
    """Path -> numpy leaf; torch fp8 codes come out as their uint8 bits."""
    def np_(v):
        if not isinstance(v, torch.Tensor):
            return np.asarray(v)
        if v.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            return v.view(torch.uint8).numpy()
        return v.float().numpy()

    return {k: np_(v) for k, v in tcm.flatten_paths(tree).items()}


def fp8_index(x: np.ndarray) -> np.ndarray:
    u = x.view(np.uint8).astype(np.int32)
    return np.where(u >= 128, 128 - u, u)


# ---------------------------------------------------------------------------
# (c) the attention Function
# ---------------------------------------------------------------------------

class TestAttentionFunction:
    @pytest.mark.parametrize("h,kvh", [(8, 1), (4, 2)])
    def test_grads_match_jax(self, h, kvh):
        rng = np.random.default_rng(2)
        b, t, s, d, scale = 2, 9, 13, 16, 0.3
        q = rng.standard_normal((b, t, h, d), dtype=np.float32)
        k, v = (rng.standard_normal((b, s, kvh, d), dtype=np.float32) for _ in range(2))
        mask = rng.random((b, t, s)) > 0.3
        mask[:, :, 0] = True  # every query attends to something
        cot = rng.standard_normal((b, t, h, d), dtype=np.float32)

        def jloss(q_, k_, v_):
            return jnp.sum(jattn.xla_attention(q_, k_, v_, jnp.asarray(mask), scale) * cot)

        ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = tattn.multi_head_attention(tq, tk, tv, torch.from_numpy(mask), impl="pallas", scale=scale)
        assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
        np.testing.assert_allclose(out.detach().numpy(), flash_attention_reference(
            *(x.detach() for x in (tq, tk, tv)), torch.from_numpy(mask), scale).numpy(), atol=0, rtol=0)
        grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), (tq, tk, tv))
        for got, want in zip(grads, ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)

    def test_no_grad_path_skips_the_function(self):
        x = torch.zeros(1, 3, 2, 16)
        assert tattn.multi_head_attention(x, x[:, :, :1], x[:, :, :1], impl="pallas").grad_fn is None


# ---------------------------------------------------------------------------
# (d) the joint pass and the loss
# ---------------------------------------------------------------------------

class TestJointAndLoss:
    @pytest.mark.parametrize("suffix_only", [False, True])
    def test_forward_joint(self, cfgs, jparams, tparams, suffix_only):
        jc, tc = cfgs
        rng = np.random.default_rng(3)
        b, p_len, s_len = 2, 7, 5
        x_pre = rng.standard_normal((b, p_len, jc.vlm.width), dtype=np.float32)
        x_suf = rng.standard_normal((b, s_len, jc.expert.width), dtype=np.float32)
        pad = np.ones((b, p_len + s_len), bool)
        pad[1, 4:p_len] = False
        att = np.zeros((b, p_len + s_len), np.int32)
        att[:, p_len:p_len + 2] = 1
        mask = np.array(j_masks(jnp.asarray(pad), jnp.asarray(att)))
        pos = (np.cumsum(pad, axis=1) - 1).astype(np.int32)
        fwd = jax.jit(jgemma.forward_joint, static_argnums=(6, 7, 8, 9, 10))
        ref = fwd(jparams["vlm"], jparams["expert"], *map(jnp.asarray, (x_pre, x_suf, mask, pos)),
                  jc.vlm, jc.expert, J32, "pallas", suffix_only)
        out = tgemma.forward_joint(tparams["vlm"], tparams["expert"], *map(torch.from_numpy, (x_pre, x_suf, mask, pos)),
                                   tc.vlm, tc.expert, T32, "pallas", suffix_only=suffix_only)
        for o, r in zip(out, ref):
            if r is None:
                assert o is None
            else:
                np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("impl", ["pallas", "xla"])
    def test_compute_loss_and_grads(self, cfgs, tparams, batch, jax_loss_grads, impl):
        """Off a TPU the JAX "pallas" attention is the plain path, so one JAX
        loss and gradient is the reference for both of the port's paths."""
        jc, tc = cfgs[0], dataclasses.replace(cfgs[1], attention_impl=impl)
        key, jloss, jgrads = jax_loss_grads
        noise, time = jax_flow_draws(key, jc, batch["actions"].shape)
        tp = tcm.tree_map(lambda x: x.detach().clone().requires_grad_(), tparams)
        tloss, aux = tpi0.compute_loss(tp, None, {k: torch.from_numpy(v) for k, v in batch.items()}, tc, T32,
                                       noise=torch.from_numpy(noise), time=torch.from_numpy(time))
        assert aux["losses"].shape == batch["actions"].shape
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
        leaves = tcm.flatten_paths(tp)
        tgrads = torch.autograd.grad(tloss, list(leaves.values()), allow_unused=True, materialize_grads=True)
        want = flat(jgrads)
        for path, got in zip(leaves, tgrads):
            scale = np.abs(want[path]).max()
            if path in STRUCTURALLY_ZERO:
                assert np.abs(got.numpy()).max() < 1e-6 and scale < 1e-6
                continue
            np.testing.assert_allclose(got.numpy(), want[path], atol=1e-4 * scale, rtol=1e-4, err_msg=path)

    def test_sample_time_is_the_reference_distribution(self, cfgs):
        t = tpi0.sample_time(np.random.default_rng(5), 20_000, cfgs[1]).numpy()
        cfg = cfgs[1]
        assert t.dtype == np.float32 and t.min() >= cfg.time_offset and t.max() <= cfg.time_offset + cfg.time_scale
        mean = cfg.time_beta_alpha / (cfg.time_beta_alpha + cfg.time_beta_beta) * cfg.time_scale + cfg.time_offset
        assert abs(t.mean() - mean) < 0.01  # Beta(1.5, 1): std 0.24, se of the mean 0.0017

    def test_expert_only_path_not_ported(self, cfgs, tparams, batch):
        """The name is historical: the frozen-prefix (train_expert_only) path
        is ported now, and this checks that its loss equals the joint path's
        on the same noise and time (the expert sees the same prefix K/V)."""
        cfg = dataclasses.replace(cfgs[1], train_expert_only=True)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        losses = [tpi0.compute_loss(tparams, np.random.default_rng(0), tb, cfg, T32, train=train)[0].item()
                  for train in (True, False)]
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


@pytest.fixture(scope="module")
def jax_loss_grads(cfgs, jparams, batch):
    """jax.value_and_grad of compute_loss under key 4, and the key."""
    key = jax.random.key(4)
    fn = jax.jit(jax.value_and_grad(
        lambda p: jpi0.compute_loss(p, key, {k: jnp.asarray(v) for k, v in batch.items()}, cfgs[0], J32)[0]))
    loss, grads = fn(jparams)
    return key, float(loss), jax.tree.map(np.asarray, grads)


class TestSchedule:
    @pytest.mark.parametrize("kw", [
        dict(max_lr=5e-5, first_cycle_steps=30_000, warmup_steps=200, min_lr=2.5e-6),
        dict(max_lr=1e-3, first_cycle_steps=10, warmup_steps=3, min_lr=1e-5, cycle_mult=2.0, gamma=0.5),
    ])
    def test_matches_jax(self, kw):
        js, ts = j_schedule(**kw), t_schedule(**kw)
        for count in (0, 1, 2, 3, 7, 10, 25, 199, 200, 201, 15_000, 29_999, 45_000):
            np.testing.assert_allclose(ts(count), float(js(count)), rtol=2e-6)

    def test_optimizer_config_fields_match(self):
        assert {f.name: f.default for f in dataclasses.fields(TOpt)} == {
            f.name: f.default for f in dataclasses.fields(JOpt)}


# ---------------------------------------------------------------------------
# (e) the fused step, port against the JAX leaf path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_steps(cfgs, jparams, batch):
    """Two fused steps in each package from the same state; the port counts
    the row updates that go through the kernel's wrapper."""
    jc, tc = cfgs
    js = jfj.init_fused_state(jparams, seed=7, min_quant_elems=64, block_size=8)
    ts = convert.from_jax_fused_state(js, tc, seed=7, device="cpu", block_size=8, min_quant_elems=64)
    init = {name: flat(getattr(ts, name)) for name in ("params", "mu", "nu")}
    jstep = jax.jit(jfj.make_fused_joint_step(jc, JOpt(**OPT_KW), J32, pallas_mode="interpret", update_impl="leaf",
                                              min_quant_elems=64, **FUSED_KW))
    tstep = tfj.make_fused_joint_step(tc, TOpt(**OPT_KW), T32, pallas_mode="on", **FUSED_KW)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    calls = []
    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        real = tfj.fused_adam_rows
        mp.setattr(tfj, "fused_adam_rows", lambda *a, **k: (calls.append(a[0].shape), real(*a, **k))[1])
        for _ in range(2):
            _, k_flow, _ = jax.random.split(js.rng, 3)
            noise, time = jax_flow_draws(k_flow, jc, batch["actions"].shape)
            js, jm = jstep(js, jb)
            ts, tm = tstep(ts, tb, noise=torch.from_numpy(noise), time=torch.from_numpy(time))
            metrics.append((jm, tm))
    return js, ts, metrics, calls, init


class TestFusedStep:
    def test_kernel_path_taken(self, cfgs, jparams, two_steps):
        calls = two_steps[3]
        n_trunk = sum(pallas_adam.eligible(int(np.prod(x.shape[1:])), 8)
                      for t in ("vlm", "expert") for x in jax.tree.leaves(jparams[t]["blocks"]))
        n_embed = sum(pallas_adam.eligible(x.size, 8) and x.size >= 64
                      for k in tfj.EMBED_NAMES for x in jax.tree.leaves(jparams[k]))
        assert n_trunk > 0 and n_embed > 0
        assert len(calls) == 2 * (n_trunk * cfgs[0].vlm.depth + n_embed)

    def test_loss_and_grad_norm(self, two_steps):
        for jm, tm in two_steps[2]:
            np.testing.assert_allclose(tm["l2_loss"].item(), float(jm["l2_loss"]), rtol=1e-5)
            np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        assert two_steps[1].count == int(two_steps[0].count) == 2

    def test_params(self, two_steps):
        js, ts, _, _, init = two_steps
        want, got = flat(jax.tree.map(np.asarray, js.params)), flat(ts.params)
        assert set(want) == set(got)
        for path in want:
            if path in STRUCTURALLY_ZERO:
                assert np.abs(got[path] - init["params"][path]).max() <= 2 * 2 * OPT_KW["lr"]
                continue
            np.testing.assert_allclose(got[path], want[path], rtol=2e-4, atol=1e-4, err_msg=path)
        # frozen embedding untouched
        np.testing.assert_array_equal(got["vlm_embed/embedding"], init["params"]["vlm_embed/embedding"])

    @pytest.mark.parametrize("name", ["mu", "nu"])
    def test_moments(self, two_steps, name):
        js, ts, _, _, init = two_steps
        want, got = flat(jax.tree.map(np.asarray, getattr(js, name))), flat(getattr(ts, name))
        assert set(want) == set(got)
        for path in want:
            if any(path.startswith(z) for z in STRUCTURALLY_ZERO):
                continue
            w, g = want[path], got[path]
            if path.endswith("/q") and w.dtype.name.startswith("float8"):
                # a moment that lands within rounding of a code boundary takes
                # either code, and the next step carries that code step on:
                # decoded values agree to two code steps of the row's top
                # binade, and the codes differ on at most 1% of the elements (or one)
                fp8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}[w.dtype.name]
                step = 2.0**-3 if fp8 == torch.float8_e4m3fn else 2.0**-2
                s_w, s_g = want[path[:-1] + "scale"], got[path[:-1] + "scale"]
                dw = w.astype(np.float32) * s_w[..., None]
                dg = torch.from_numpy(g).view(fp8).float().numpy() * s_g[..., None]
                row_max = np.abs(dw).max(axis=-1, keepdims=True)
                assert np.all(np.abs(dg - dw) <= 2 * step * row_max + 1e-4 * row_max.max()), path
                assert (fp8_index(w) != fp8_index(g)).sum() <= max(1, w.size // 100), path
            else:
                np.testing.assert_allclose(g, w, atol=1e-4 * max(np.abs(w).max(), 1e-30), rtol=0, err_msg=path)
        # the VLM final_norm gets no gradient: its moments stay at their initial values
        np.testing.assert_array_equal(got["vlm/final_norm/scale"], init[name]["vlm/final_norm/scale"])

    def test_state_carries_fp8_codes_bit_for_bit(self, cfgs, jparams):
        js = jfj.init_fused_state(jparams, seed=7, min_quant_elems=64, block_size=8)
        q = js.mu["vlm"]["blocks"]["q"]
        codes = jnp.asarray(np.random.default_rng(6).integers(0, 256, q.shape, dtype=np.uint8)).view(q.dtype)
        js.mu["vlm"]["blocks"]["q"] = codes
        ts = convert.from_jax_fused_state(js, cfgs[1], seed=7, device="cpu", block_size=8, min_quant_elems=64)
        assert ts.mu["vlm"]["blocks"]["q"].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(ts.mu["vlm"]["blocks"]["q"].view(torch.uint8).numpy(),
                                      np.asarray(codes).view(np.uint8))
        with pytest.raises(ValueError, match="unconsumed"):
            js.nu["extra"] = np.zeros(3, np.float32)
            convert.from_jax_fused_state(js, cfgs[1], seed=7, device="cpu", block_size=8, min_quant_elems=64)

    def test_delayed_clip_and_no_update_mode(self, cfgs, tparams, batch):
        tc = cfgs[1]
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        opt = TOpt(**{**OPT_KW, "max_grad_norm": 1e-3})
        fresh = tcm.tree_map(lambda x: x.clone(), tparams)
        state = tfj.init_fused_state(fresh, seed=3, block_size=8, min_quant_elems=64)
        step = tfj.make_fused_joint_step(tc, opt, T32, **FUSED_KW)
        state, m1 = step(state, tb)
        assert m1["clip_factor"].item() == 1.0  # no previous norm yet
        state, m2 = step(state, tb)
        np.testing.assert_allclose(m2["clip_factor"].item(), 1e-3 / m1["grad_norm"].item(), rtol=1e-6)
        # apply_updates=False: the full backward and the exact norm, no writes
        frozen = tfj.make_fused_joint_step(tc, opt, T32, apply_updates=False, **FUSED_KW)
        before = {k: v.copy() for k, v in flat(state.params).items()}
        mu_before = {k: v.copy() for k, v in flat(state.mu).items()}
        _, m3 = frozen(state, tb, noise=torch.zeros(batch["actions"].shape), time=torch.full((2,), 0.5))
        assert np.isfinite(m3["grad_norm"].item()) and m3["grad_norm"].item() > 0
        for k, v in flat(state.params).items():
            np.testing.assert_array_equal(v, before[k])
        for k, v in flat(state.mu).items():
            np.testing.assert_array_equal(v, mu_before[k])

    def test_fp32_masters_hand_the_row_update_fp32_p_and_g(self, cfgs, tparams, batch, monkeypatch):
        """With fp32 parameters under bf16 compute (master_dtype float32), every
        leaf the step sends to fused_adam_rows comes with a gradient of its own
        dtype, fp32: the pair the CUDA kernel takes."""
        seen = []
        real = tfj.fused_adam_rows

        def record(p, g, *args, **kw):
            seen.append((p.dtype, g.dtype))
            return real(p, g, *args, **kw)

        monkeypatch.setattr(tfj, "fused_adam_rows", record)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        state = tfj.init_fused_state(tcm.tree_map(lambda x: x.clone(), tparams), seed=3, block_size=8,
                                     min_quant_elems=64)
        policy = tcm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
        step = tfj.make_fused_joint_step(cfgs[1], TOpt(**OPT_KW), policy, **FUSED_KW)
        _, metrics = step(state, tb)
        assert np.isfinite(metrics["grad_norm"].item())
        assert seen and set(seen) == {(torch.float32, torch.float32)}

    def test_pallas_mode_is_checked(self, cfgs):
        with pytest.raises(ValueError, match="pallas_mode"):
            tfj.make_fused_joint_step(cfgs[1], TOpt(), T32, pallas_mode="interpret")


# ---------------------------------------------------------------------------
# (f) data, trainer, CLI
# ---------------------------------------------------------------------------

RECIPE = "config/train/pi0_finetune_bridge_1chip.yaml"
TINY_OVERRIDES = {"global_batch_size": "2", "per_device_batch_size": "2", "n_updates": "2", "log_freq": "1",
                  "tokenizer_path": "hash"}


@pytest.fixture
def tiny_recipe(monkeypatch, cfgs, tmp_path):
    """The 1-chip recipe at tiny(), its checkpoints under tmp_path (the
    trainer saves its last update)."""
    from intact_tpu_torch.config import pipeline

    monkeypatch.setattr(pipeline, "pi0_config_from_json", lambda d: cfgs[1])
    from pathlib import Path

    from intact_tpu_torch import run

    argv = ["--config_path", str(Path(__file__).resolve().parent.parent / RECIPE)]
    for k, v in TINY_OVERRIDES.items():
        argv += [f"--{k}", v]
    argv += ["--log_dir", str(tmp_path)]
    return run, argv


class TestTrainer:
    def test_recipe_binds(self, tiny_recipe):
        run, argv = tiny_recipe
        cfg, device = run.build_config(argv + ["--device", "cpu"])
        assert device == "cpu"
        assert cfg.fused_update and cfg.master_dtype == "bfloat16" and cfg.n_updates == 2
        assert cfg.model_cfg["attention_implementation"] == "pallas"
        from intact_tpu_torch.config.pipeline import optimizer_config_from_model_json

        opt = optimizer_config_from_model_json(cfg.model_cfg, cfg)
        assert (opt.lr, opt.weight_decay, opt.warmup_steps, opt.first_cycle_steps) == (5e-5, 0.0, 200, 30_000)

    def test_two_steps_from_the_recipe(self, tiny_recipe, caplog):
        from intact_tpu_torch.train.trainer import Trainer

        run, argv = tiny_recipe
        cfg, _ = run.build_config(argv)
        trainer = Trainer(cfg, device="cpu")
        assert trainer.bf16_masters  # the recipe's precision: bf16 params, stochastic rounding
        embed = trainer.state.params["vlm_embed"]["embedding"].clone()
        q0 = trainer.state.params["vlm"]["blocks"]["attn"]["q"]["kernel"].clone()
        with caplog.at_level("INFO", logger="intact_tpu_torch.trainer"):
            trainer.train()
        assert trainer.cnt_update == 2 and trainer.state.count == 2
        assert torch.isfinite(trainer.state.prev_gnorm) and trainer.state.prev_gnorm.item() > 0
        assert torch.equal(trainer.state.params["vlm_embed"]["embedding"], embed)
        assert not torch.equal(trainer.state.params["vlm"]["blocks"]["attn"]["q"]["kernel"], q0)
        lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("update")]
        assert len(lines) == 2 and "l2_loss" in lines[0] and "grad_norm" in lines[0] and "lr" in lines[0]

    def test_two_steps_with_fp32_masters(self, tiny_recipe):
        """master_dtype float32: fp32 trainable parameters (the frozen
        embedding in bf16), no stochastic rounding; the trainer takes it on
        any device now that the row kernel takes fp32 p."""
        from intact_tpu_torch.train.trainer import Trainer

        run, argv = tiny_recipe
        cfg, _ = run.build_config(argv + ["--master_dtype", "float32"])
        trainer = Trainer(cfg, device="cpu")
        assert not trainer.bf16_masters
        q = trainer.state.params["vlm"]["blocks"]["attn"]["q"]["kernel"]
        assert q.dtype == torch.float32 and trainer.state.params["vlm_embed"]["embedding"].dtype == torch.bfloat16
        q0 = q.clone()
        trainer.train()
        assert trainer.cnt_update == 2 and torch.isfinite(trainer.state.prev_gnorm)
        assert not torch.equal(trainer.state.params["vlm"]["blocks"]["attn"]["q"]["kernel"], q0)

    def test_trainer_raises_without_cuda_unless_given_cpu(self, tiny_recipe):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device is valid here")
        from intact_tpu_torch.train.trainer import Trainer

        run, argv = tiny_recipe
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(run.build_config(argv)[0])

    @pytest.mark.parametrize("override,error", [
        ({"global_batch_size": "4"}, "accumulation"),
        ({"quantize_frozen_int8": "true"}, "standard"),
        ({"data.backend": "rlds", "data.train.service_address": "grpc://localhost:1"}, "RLDS"),
        ({"freeze_vlm": "true"}, "freeze"),
    ])
    def test_refusals(self, tiny_recipe, override, error):
        from intact_tpu_torch.train.trainer import Trainer

        run, argv = tiny_recipe
        for k, v in override.items():
            argv = argv + [f"--{k}", v]
        cfg, _ = run.build_config(argv)
        with pytest.raises((ValueError, NotImplementedError), match=error):
            Trainer(cfg, device="cpu")

    def test_preprocess_and_data_match_jax(self, cfgs):
        from intact_tpu.config.pipeline import DataConfig as JData
        from intact_tpu.data.dataset import InterleavedDataset as JDataset
        from intact_tpu.models.tokenizer import HashTokenizer as JTok
        from intact_tpu.train.trainer import preprocess_batch as j_pre
        from intact_tpu_torch.config.pipeline import DataConfig as TData
        from intact_tpu_torch.data.dataset import InterleavedDataset as TDataset
        from intact_tpu_torch.models.tokenizer import HashTokenizer as TTok
        from intact_tpu_torch.train.trainer import preprocess_batch as t_pre

        jd, td = JData(backend="synthetic"), TData(backend="synthetic")
        for d in (jd, td):
            d.train.action_horizon = 4
        stats = {"action": jd.dataset_stats["action"], "proprio": jd.dataset_stats["observation.state"]}
        raw_j = next(iter(JDataset(jd, 3, stats=stats, normalization_type="bound", seed=5, image_size=28)))
        raw_t = next(iter(TDataset(td, 3, stats=stats, normalization_type="bound", seed=5, image_size=28)))
        for k, v in flat(raw_j).items():
            np.testing.assert_array_equal(flat(raw_t)[k], v, err_msg=k)
        ref = j_pre(raw_j, JTok(256, 8), cfgs[0])
        out = t_pre(raw_t, TTok(256, 8), cfgs[1])
        assert set(out) == set(ref)
        for k in ref:
            np.testing.assert_allclose(out[k], np.asarray(ref[k]), rtol=1e-6, atol=1e-7, err_msg=k)
