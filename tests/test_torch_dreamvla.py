"""The PyTorch port's DreamVLA against the JAX package's, on the CPU.

Both run `DreamVLAConfig.tiny()` in fp32 on parameters made by the jitted
JAX `init` and carried across by `convert.from_jax_params`, on a seeded
numpy batch (two frames, so the world-model loss is taken; the auxiliary
targets present or absent); the JAX side runs compiled. Tolerances, each with
the value measured when it was set:
  * forward (actions, latents, predicted latents, the auxiliary heads) and
    every loss: 1e-5 relative L2 (the same fp32 ops through SigLIP, the
    resampler and the backbone, sums in another order; measured at most
    6.4e-7);
  * every leaf's gradient: 1e-4 relative L2 (measured at most 1.6e-6); a leaf
    whose exact gradient is 0 (an attention key bias, the resampler's too:
    the softmax cancels it) within 1e-6 of the gradient's norm on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intact_tpu.models import common as jcm
from intact_tpu.models import dreamvla as jdv
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models import dreamvla as tdv

J32 = jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
T32 = tcm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
RTOL = 1e-5
GRAD_RTOL = 1e-4
AUX = ("dynamic_mask", "depth", "semantic")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def t_(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def model():
    jc, tc = jdv.DreamVLAConfig.tiny(), tdv.DreamVLAConfig.tiny()
    jp = jax.jit(jdv.init, static_argnums=1)(jax.random.key(0), jc)
    return jc, tc, jp, convert.from_jax_params(jax.tree.map(np.asarray, jp), tc, device="cpu")


def make_batch(cfg, t: int = 2) -> dict:
    rng = np.random.default_rng(3)
    b, s, g = 2, cfg.vision.image_size, cfg.vision.grid
    return {
        "images": rng.uniform(-1, 1, (b, t, s, s, 3)).astype(np.float32),
        "actions": rng.uniform(-1, 1, (b, cfg.horizon + 1, cfg.action_dim)).astype(np.float32),
        "dynamic_mask": (rng.uniform(size=(b, t, g, g)) > 0.5).astype(np.float32),
        "depth": rng.uniform(0.5, 2.0, (b, t, g, g)).astype(np.float32),
        "semantic": rng.standard_normal((b, t, cfg.num_latents, cfg.semantic_dim), dtype=np.float32),
    }


def test_bridge_fills_every_parameter(model):
    jc, tc, jp, tp = model
    want = {k: tuple(np.shape(v)) for k, v in tcm.flatten_paths(jax.tree.map(np.asarray, jp)).items()}
    assert {k: tuple(v.shape) for k, v in tcm.flatten_paths(tp).items()} == want
    assert {k: tuple(v.shape) for k, v in tcm.flatten_paths(tdv.init(tc, device="meta")).items()} == want


def test_forward_matches(model):
    jc, tc, jp, tp = model
    batch = make_batch(jc)
    ref = jax.jit(lambda p, x: jdv.forward(p, x, jc, J32))(jp, batch["images"])
    ours = tdv.forward(tp, t_(batch["images"]), tc, T32)
    for name, a, b in zip(("actions", "latents", "pred_next"), ours[:3], ref[:3]):
        assert a.shape == b.shape and rel(a.detach().numpy(), b) <= RTOL, name
    assert ours[3].keys() == ref[3].keys()
    for name in ref[3]:
        assert rel(ours[3][name].detach().numpy(), ref[3][name]) <= RTOL, name


@pytest.mark.parametrize("targets", ["all", "none", "depth_only", "one_frame"])
def test_loss_and_gradients_match(model, targets):
    """compute_loss (action, world and the auxiliary losses whose targets
    the batch carries; one frame leaves the world loss at 0) and every
    leaf's gradient against jax.grad."""
    jc, tc, jp, tp = model
    batch = make_batch(jc, t=1 if targets == "one_frame" else 2)
    keep = {"all": AUX, "none": (), "depth_only": ("depth",), "one_frame": AUX}[targets]
    batch = {k: v for k, v in batch.items() if k not in AUX or k in keep}
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, b: jdv.compute_loss(p, None, b, jc, J32), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    views = {k: v.detach().clone().requires_grad_() for k, v in tcm.flatten_paths(tp).items()}
    loss, metrics = tdv.compute_loss(tcm.unflatten_paths(views), None, {k: t_(v) for k, v in batch.items()}, tc, T32)
    assert metrics.keys() == jm.keys()
    for name in jm:
        assert abs(metrics[name].item() - float(jm[name])) <= RTOL * max(abs(float(jm[name])), 1e-12), name
    if targets == "one_frame":
        assert metrics["world_loss"].item() == float(jm["world_loss"]) == 0.0
    grads = dict(zip(views, torch.autograd.grad(loss, list(views.values()), allow_unused=True,
                                                materialize_grads=True)))
    jflat = {k: np.asarray(v) for k, v in tcm.flatten_paths(jax.tree.map(np.asarray, jg)).items()}
    assert jflat.keys() == grads.keys()
    zero = [k for k in jflat if k.endswith(("attn/k/bias", "resampler/k/bias"))]  # exact 0: the softmax cancels it
    total = np.sqrt(sum(np.square(g).sum() for g in jflat.values()))
    assert zero and all(max(np.linalg.norm(jflat[k]), grads[k].norm().item()) <= 1e-6 * total for k in zero)
    for k in jflat:
        if k not in zero:
            assert rel(grads[k].numpy(), jflat[k]) <= GRAD_RTOL, k
