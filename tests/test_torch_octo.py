"""The PyTorch port's Octo family and T5 encoder against the JAX package's,
on the CPU (the importers, the serving wrapper and the adapter:
tests/test_torch_octo_io.py).

Both packages run the tiny configs (`OctoConfig.tiny()`, the upstream
`tiny_test_config()` with its tiny T5) in fp32 on parameters made by the JAX
`init` (jitted) and carried across by `convert.from_jax_params`; inputs come
from seeded numpy generators, with ragged language masks and a padded history
frame; the JAX side runs compiled (`jax.jit`). The diffusion draws are the
JAX ones, fed to the port: the sampler's x_T and per-step noise follow the key
splits of intact_tpu/models/diffusion.py:85-91, the loss's timesteps and
noise those of its `training_loss`. Tolerances, each with the value measured
when it was set:
  * T5 and Octo encodes, eps at every tested t, losses: 1e-5 relative L2 (the
    same fp32 ops, sums in another order through a few layers; measured at
    most 8.2e-7);
  * sampled actions and every leaf's gradient: 1e-4 relative L2 (DDPM divides
    by sqrt(alpha) each step, which amplifies the rounding; measured at most
    6.0e-7 for the samples and 4.5e-6 for a gradient); a leaf whose exact gradient is 0 (an attention key bias, which
    the softmax cancels; a stem conv bias that its one-channel GroupNorm
    groups cancel) within 1e-6 of the gradient's norm on both sides;
  * the buckets: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intact_tpu.models import common as jcm
from intact_tpu.models import t5 as jt5
from intact_tpu.models.octo import model as joct
from intact_tpu.models.octo import upstream as jup
from intact_tpu.models.octo.config import OctoConfig as JOcto
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models import t5 as tt5
from intact_tpu_torch.models.octo import model as toct
from intact_tpu_torch.models.octo import upstream as tup
from intact_tpu_torch.models.octo.config import OctoConfig as TOcto

J32 = jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
T32 = tcm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
ENC_RTOL = 1e-5
SAMPLE_RTOL = 1e-4
INPUTS = ("images", "img_masks", "lang_tokens", "lang_masks")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def t_(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def flat_np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tcm.flatten_paths(tree).items()}


# ---------------------------------------------------------------------------
# models: the JAX init, its params carried across, a seeded batch
# ---------------------------------------------------------------------------

KINDS = {
    "native": (JOcto.tiny, TOcto.tiny, joct, toct),
    "native_proprio": (lambda: dataclasses.replace(JOcto.tiny(), use_proprio=True),
                       lambda: dataclasses.replace(TOcto.tiny(), use_proprio=True), joct, toct),
    "native_ddim": (lambda: dataclasses.replace(JOcto.tiny(), sample_steps=4),
                    lambda: dataclasses.replace(TOcto.tiny(), sample_steps=4), joct, toct),
    "upstream": (jup.tiny_test_config, tup.tiny_test_config, jup, tup),
    # a bound the tiny model's samples cross, so the per-step clip acts
    "upstream_clipped": (lambda: dataclasses.replace(jup.tiny_test_config(), max_action=0.2),
                         lambda: dataclasses.replace(tup.tiny_test_config(), max_action=0.2), jup, tup),
}
_BUILT: dict = {}


def build(kind: str):
    """(jax cfg, port cfg, jax module, port module, jax params, port params),
    once per process and parameter layout."""
    jmake, tmake, jmod, tmod = KINDS[kind]
    jc, tc = jmake(), tmake()
    layout = (jmod.__name__, getattr(jc, "use_proprio", False))
    if layout not in _BUILT:
        jp = jax.jit(jmod.init, static_argnums=1)(jax.random.key(0), jc)
        _BUILT[layout] = (jp, convert.from_jax_params(jax.tree.map(np.asarray, jp), tc, device="cpu"))
    return (jc, tc, jmod, tmod) + _BUILT[layout]


def make_batch(cfg, b: int = 2, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    lt = cfg.max_lang_tokens
    vocab = cfg.t5.vocab_size if hasattr(cfg, "t5") else cfg.vocab_size
    lang_masks = np.zeros((b, lt), bool)
    lang_masks[0, :lt - 1] = True
    lang_masks[1, :3] = True  # ragged language padding
    s, t = cfg.image_size, cfg.history
    return {
        "images": rng.uniform(-1, 1, (b, t, s, s, 3)).astype(np.float32),
        "img_masks": np.array([[True] * t, [False] + [True] * (t - 1)]),  # row 1: a padded first frame
        "lang_tokens": rng.integers(1, vocab, (b, lt)).astype(np.int32),
        "lang_masks": lang_masks,
        "state": rng.standard_normal((b, 7), dtype=np.float32),
        "actions": rng.uniform(-1, 1, (b, cfg.horizon, cfg.action_dim)).astype(np.float32),
        "x_t": rng.standard_normal((b, cfg.horizon, cfg.action_dim), dtype=np.float32),
        "cond": rng.standard_normal((b, cfg.width), dtype=np.float32),
    }


def j_encode(kind, jc, jmod, jp, batch):
    if jmod is joct:
        return jax.jit(lambda p, *a: joct.encode(p, *a, jc, J32, proprio=batch["state"] if jc.use_proprio else None))(
            jp, *(batch[k] for k in INPUTS))
    return jax.jit(lambda p, *a: jup.encode(p, *a, jc, J32))(jp, *(batch[k] for k in INPUTS))


def t_encode(tc, tmod, tp, batch, images=None):
    args = [t_(batch[k]) for k in INPUTS]
    if images is not None:
        args[0] = images
    if tmod is toct:
        return toct.encode(tp, *args, tc, T32, proprio=t_(batch["state"]) if tc.use_proprio else None)
    return tup.encode(tp, *args, tc, T32)


def test_bridge_fills_every_parameter():
    for kind in ("native", "native_proprio", "upstream"):
        jc, tc, _, tmod, jp, tp = build(kind)
        want = {k: tuple(v.shape) for k, v in tcm.flatten_paths(jax.tree.map(np.asarray, jp)).items()}
        assert {k: tuple(v.shape) for k, v in tcm.flatten_paths(tp).items()} == want, kind
        meta = {k: tuple(v.shape) for k, v in tcm.flatten_paths(tmod.init(tc, device="meta")).items()}
        assert meta == want, kind


# ---------------------------------------------------------------------------
# T5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("buckets,distance", [(32, 128), (16, 64), (64, 256)])
def test_t5_buckets_equal_jax(buckets, distance):
    """Every relative position in [-L, L], past the max distance, lands in
    the JAX bucket (the boundaries at powers of two included)."""
    L = 4 * distance
    rp = np.arange(-L, L + 1, dtype=np.int32)
    ref = np.asarray(jax.jit(jt5.relative_position_bucket, static_argnums=(1, 2))(rp, buckets, distance))
    ours = tt5.relative_position_bucket(torch.from_numpy(rp), buckets, distance)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_t5_encode_matches_jax():
    jc, tc = jt5.tiny_test_config(), tt5.tiny_test_config()
    jp = jax.jit(jt5.init, static_argnums=1)(jax.random.key(3), jc)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(4)
    ids = rng.integers(1, jc.vocab_size, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), bool)
    mask[1, 5:] = False
    ref = np.asarray(jax.jit(lambda p, i, m: jt5.encode(p, i, m, jc, J32))(jp, ids, mask))
    ours = tt5.encode(tp, t_(ids), t_(mask), tc, T32)
    assert rel(ours.numpy(), ref) <= ENC_RTOL
    bias = tt5._position_bias(tp, 9, 9, tc)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jt5._position_bias(jp, 9, 9, jc)))


# ---------------------------------------------------------------------------
# Octo: encode, eps, sampling, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["native", "native_proprio", "upstream"])
def test_encode_matches(kind):
    jc, tc, jmod, tmod, jp, tp = build(kind)
    batch = make_batch(jc)
    ref = np.asarray(j_encode(kind, jc, jmod, jp, batch))
    ours = t_encode(tc, tmod, tp, batch)
    assert ours.shape == (2, jc.history, jc.width)
    assert rel(ours.numpy(), ref) <= ENC_RTOL


def test_upstream_stem_takes_uint8():
    """The stem's own uint8 branch (x / 127.5 - 1), as the reference's."""
    jc, tc, _, _, jp, tp = build("upstream")
    u8 = np.random.default_rng(2).integers(0, 256, (3, jc.image_size, jc.image_size, 3), dtype=np.uint8)
    ref = np.asarray(jax.jit(lambda p, x: jup.small_stem_encode(p, x, jc, J32))(jp["stem_primary"], u8))
    ours = tup.small_stem_encode(tp["stem_primary"], t_(u8), tc, T32)
    assert ours.shape == (3, jc.n_patches, jc.stem_embed_features)
    assert rel(ours.numpy(), ref) <= ENC_RTOL


def j_eps(kind, jc, jmod, jp):
    if jmod is joct:
        return jax.jit(lambda p, x, t, c: joct._eps_fn(p, jc, J32, x, t, c))
    return jax.jit(lambda p, x, t, c: jup._eps_fn(p, jc, x, t, c))


@pytest.mark.parametrize("kind", ["native", "upstream"])
@pytest.mark.parametrize("step", ["first", "middle", "last"])
def test_eps_fn_matches(kind, step):
    jc, tc, jmod, tmod, jp, tp = build(kind)
    batch = make_batch(jc)
    t = {"first": 0, "middle": jc.diffusion_steps // 2, "last": jc.diffusion_steps - 1}[step]
    t_int = np.array([t, max(t - 1, 0)], np.int32)
    ref = np.asarray(j_eps(kind, jc, jmod, jp)(jp, batch["x_t"], t_int, batch["cond"]))
    if tmod is toct:
        ours = toct._eps_fn(tp, tc, T32, t_(batch["x_t"]), t_(t_int), t_(batch["cond"]))
    else:
        ours = tup._eps_fn(tp, tc, t_(batch["x_t"]), t_(t_int), t_(batch["cond"]))
    assert rel(ours.numpy(), ref) <= ENC_RTOL


def ddpm_draws(key, shape, steps: int):
    """The reference ddpm_sample's x_T and the noise of its steps t = T-1..1."""
    k_init, k = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(k_init, shape, jnp.float32))
    draws = []
    for _ in range(steps - 1):
        k, k_noise = jax.random.split(k)
        draws.append(t_(jax.random.normal(k_noise, shape, jnp.float32)))
    return t_(x_T), draws


@pytest.mark.parametrize("kind", ["native", "native_ddim", "upstream", "upstream_clipped"])
def test_sample_actions_matches(kind):
    """The JAX sampler's draws replayed into the port (DDPM: x_T and every
    step's noise; DDIM, deterministic: x_T)."""
    jc, tc, jmod, tmod, jp, tp = build(kind)
    batch = make_batch(jc)
    key = jax.random.key(7)
    ref = np.asarray(jax.jit(lambda p, k, *a: jmod.sample_actions(p, k, *a, jc, J32))(
        jp, key, *(batch[k] for k in INPUTS), batch["state"]))
    shape = (2, jc.horizon, jc.action_dim)
    if kind == "native_ddim":
        x_T, step_noise = t_(jax.random.normal(key, shape, jnp.float32)), None
    else:
        x_T, step_noise = ddpm_draws(key, shape, jc.diffusion_steps)
    ours = tmod.sample_actions(tp, None, *(t_(batch[k]) for k in INPUTS), t_(batch["state"]), tc, T32, noise=x_T,
                               step_noise=step_noise)
    assert ours.shape == shape and ours.dtype == torch.float32
    assert rel(ours.numpy(), ref) <= SAMPLE_RTOL
    if kind == "upstream_clipped":
        assert float(np.abs(ref).max()) == float(np.float32(jc.max_action)) == ours.abs().max().item()


@pytest.mark.parametrize("kind", ["native", "native_proprio", "upstream"])
def test_loss_and_gradients_match(kind):
    """compute_loss with the reference's timesteps and noise for its key, and
    every leaf's gradient against jax.grad."""
    jc, tc, jmod, tmod, jp, tp = build(kind)
    batch = make_batch(jc)
    keys = INPUTS + ("actions", "state")
    jb = {k: jnp.asarray(batch[k]) for k in keys}
    key = jax.random.key(11)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(lambda p, b: jmod.compute_loss(p, key, b, jc, J32), has_aux=True))(
        jp, jb)
    k_t, k_noise = jax.random.split(key)
    t_int = t_(jax.random.randint(k_t, (2,), 0, jc.diffusion_steps))
    noise = t_(jax.random.normal(k_noise, batch["actions"].shape, jnp.float32))

    views = {k: v.detach().clone().requires_grad_() for k, v in tcm.flatten_paths(tp).items()}
    loss, aux = tmod.compute_loss(tcm.unflatten_paths(views), None, {k: t_(batch[k]) for k in keys}, tc, T32,
                                  t_int=t_int, noise=noise)
    grads = dict(zip(views, torch.autograd.grad(loss, list(views.values()), allow_unused=True,
                                                materialize_grads=True)))
    assert abs(loss.item() - float(jl)) <= ENC_RTOL * abs(float(jl))
    assert rel(aux["losses"].detach().numpy(), jaux["losses"]) <= ENC_RTOL
    jflat = flat_np(jax.tree.map(np.asarray, jg))
    assert jflat.keys() == grads.keys()
    # exact gradient 0: an attention key bias (the softmax cancels it) and a stem conv bias whose GroupNorm
    # groups are single channels (the norm cancels it)
    zero = [k for k in jflat if k.endswith("attn/k/bias")
            or (k.startswith("stem_primary/conv_") and k.endswith("/bias") and jflat[k].size <= 32)]
    total = np.sqrt(sum(np.square(g).sum() for g in jflat.values()))
    assert zero and all(max(np.linalg.norm(jflat[k]), grads[k].norm().item()) <= 1e-6 * total for k in zero)
    for k in jflat:
        if k not in zero:
            assert rel(grads[k].numpy(), jflat[k]) <= SAMPLE_RTOL, k
