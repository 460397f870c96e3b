"""The port's standard-step optimizers against the JAX package's, on the CPU.

`intact_tpu_torch.train.optim8bit` against `intact_tpu.train.optim8bit`, and
`intact_tpu_torch.train.optim.make_optimizer` against the optax chain of
`intact_tpu.train.optim.make_optimizer`, on trees of fp32 leaves made from
numpy seeds; `intact_tpu_torch.utils.metric` against `intact_tpu.utils.metric`.
Tolerances, each with its reason:
  * codebooks, codes and block scales: bit-equal (the same fp32 operations,
    the same boundaries);
  * parameters after AdamW steps: 1e-6 relative plus 1e-8 absolute (each
    update is ~lr = 1e-2 in size, and its fp32 operations, which XLA may
    contract into fused multiply-adds, land a few ulps of it apart);
  * fp32 moments and the running mean: 1e-6 relative plus 1e-9 absolute;
  * 8-bit moments after several steps: codes equal on at least 99.9% of the
    elements (a moment an ulp from a code boundary may land on the other
    side), every code at most one apart, scales within 1e-6;
  * the metrics: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intact_tpu.train import optim8bit as j8
from intact_tpu.train.optim import OptimizerConfig as JOpt
from intact_tpu.train.optim import make_optimizer as j_make_optimizer
from intact_tpu.utils import metric as jmetric
from intact_tpu_torch.models.common import flatten_paths, unflatten_paths
from intact_tpu_torch.train import optim8bit as t8
from intact_tpu_torch.train.optim import OptimizerConfig as TOpt
from intact_tpu_torch.train.optim import make_optimizer as t_make_optimizer
from intact_tpu_torch.utils import metric as tmetric

OPT_KW = dict(lr=1e-2, weight_decay=1e-2, warmup_steps=2, first_cycle_steps=10, min_lr=1e-4, max_grad_norm=0.5)


def np_tree(shapes: dict, rng: np.random.Generator, scale: float = 1.0) -> dict:
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


def to_torch(flat: dict) -> dict:
    return unflatten_paths({k: torch.from_numpy(np.array(v)) for k, v in flat.items()})


def to_jax(flat: dict) -> dict:
    return unflatten_paths({k: jnp.asarray(v) for k, v in flat.items()})


def assert_trees_close(got, want, rtol, atol):
    got, want = flatten_paths(got), flatten_paths(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=rtol, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# codebooks and blockwise codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("signed", [True, False])
def test_codebook_and_zero_index_match(signed):
    np.testing.assert_array_equal(t8.make_dynamic_codebook(signed), j8.make_dynamic_codebook(signed))
    assert t8.zero_index(signed) == j8.zero_index(signed)


@pytest.mark.parametrize("signed", [True, False])
def test_encode_decode_bit_equal(signed):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((7, 333)) * np.exp(rng.uniform(-12, 0, (7, 333)))).astype(np.float32)
    if not signed:
        x = np.abs(x)
    x[0, :70] = 0.0  # an all-zero block
    want = j8._encode(jnp.asarray(x), signed, block_size=64)
    got = t8.encode(torch.from_numpy(x), signed, block_size=64)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    back_j = j8._decode(want, signed, x.shape, x.size)
    back_t = t8.decode(got, signed, x.shape)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))


# ---------------------------------------------------------------------------
# AdamW (8-bit and fp32), clip, accumulation and freeze partition vs optax
# ---------------------------------------------------------------------------

def port_update(tx, grads, state: dict, params):
    """An optax-style update over the port's Optimizer: collects what apply()
    hands its sink -> (fp32 update tree, or None when not emitted; state)."""
    flat = flatten_paths(params)
    updates = {}

    def sink(path, sl, u):
        updates.setdefault(path, torch.empty(flat[path].numel(), dtype=torch.float32))[sl] = u

    if not tx.apply(grads, state, params, sink):
        return None, state
    return unflatten_paths({k: u.view(flat[k].shape) for k, u in updates.items()}), state


def run_both(cfg_kw: dict, shapes: dict, mask: dict | None, micro_steps: int, grad_scale: float = 1.0):
    """The same grads through the JAX optax chain and the port's Optimizer;
    -> (JAX params per micro-step, port params per micro-step, JAX state,
    port state)."""
    rng = np.random.default_rng(0)
    p0 = np_tree(shapes, rng)
    jtx, _ = j_make_optimizer(JOpt(**cfg_kw), None if mask is None else unflatten_paths(mask))
    ttx, _ = t_make_optimizer(TOpt(**cfg_kw), None if mask is None else unflatten_paths(mask))
    jp, tp = to_jax(p0), to_torch(p0)
    js, ts_ = jtx.init(jp), ttx.init(tp)
    j_hist, t_hist = [], []
    for _ in range(micro_steps):
        g = np_tree(shapes, rng, grad_scale)
        u, js = jax.jit(jtx.update)(to_jax(g), js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts_ = port_update(ttx, to_torch(g), ts_, tp)
        if tu is not None:
            tp = unflatten_paths({k: v + flatten_paths(tu).get(k, torch.zeros_like(v))
                                  for k, v in flatten_paths(tp).items()})
        j_hist.append(jax.tree.map(np.asarray, jp))
        t_hist.append(tp)
    return j_hist, t_hist, js, ts_


def test_make_optimizer_matches_optax_with_accumulation_and_freeze():
    """clip (active: grad norm ~4 > 0.5), AdamW with decay, warm-up lr,
    accumulation 3 over 4 micro-steps (one emit, then one accumulation), a
    frozen leaf: params after every micro-step, the running mean, the
    moments and the counters."""
    shapes = {"a/w": (4, 3), "a/b": (3,), "frozen/w": (5,), "c": (2, 2, 2)}
    mask = {"a/w": True, "a/b": True, "frozen/w": False, "c": True}
    j_hist, t_hist, js, ts_ = run_both(dict(OPT_KW, grad_accumulation_steps=3), shapes, mask, 4)
    for jp, tp in zip(j_hist, t_hist):
        assert_trees_close(tp, jp, rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(flatten_paths(t_hist[-1])["frozen/w"], flatten_paths(j_hist[0])["frozen/w"])
    multi = js.inner_states["train"].inner_state  # MultiStepsState inside the trainable partition
    adam = multi.inner_opt_state[1][0]  # chain(clip, adamw) -> adamw's ScaleByAdamState
    assert (ts_["mini_step"], ts_["gradient_step"], ts_["count"]) == (
        int(multi.mini_step), int(multi.gradient_step), int(adam.count)) == (1, 1, 1)
    for name, want in (("acc", multi.acc_grads), ("mu", adam.mu), ("nu", adam.nu)):
        masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
        want = {k: np.asarray(v) for k, v in flatten_paths(jax.tree.map(lambda x: x, want, is_leaf=masked)).items()
                if not masked(v)}
        assert set(ts_[name]) == set(want) == {"a/w", "a/b", "c"}, name  # no buffer for the frozen leaf
        for k, v in want.items():
            np.testing.assert_allclose(ts_[name][k].numpy(), v, rtol=1e-6, atol=1e-9, err_msg=f"{name} {k}")


@pytest.mark.parametrize("quantize", [True, False])
def test_accumulator_dtype_matches_multisteps(quantize):
    """Under bf16 params the running mean is held in the updates' dtype, as
    optax MultiSteps holds it after a micro-step: fp32 with 8-bit moments,
    bf16 with AdamW."""
    cfg = dict(grad_accumulation_steps=2, quantize_moments=quantize)
    jtx, _ = j_make_optimizer(JOpt(**cfg), {"a": True, "b": False})
    jp = {"a": jnp.ones((4,), jnp.bfloat16), "b": jnp.ones((3,), jnp.bfloat16)}
    _, js = jax.jit(jtx.update)(jp, jtx.init(jp), jp)
    ttx, _ = t_make_optimizer(TOpt(**cfg), {"a": True, "b": False})
    tp = {"a": torch.ones(4, dtype=torch.bfloat16), "b": torch.ones(3, dtype=torch.bfloat16)}
    state = ttx.init(tp)
    assert set(state["acc"]) == {"a"}
    assert str(state["acc"]["a"].dtype).split(".")[-1] == str(js.inner_states["train"].inner_state.acc_grads["a"].dtype)


def test_adamw8bit_matches_jax_over_steps():
    """adamw8bit (quantize_moments) with SR off: a quantized leaf (a ragged
    last block) and an exact one, 4 steps, no clipping."""
    shapes = {"big": (256, 300), "small": (7, 5)}
    kw = dict(OPT_KW, quantize_moments=True, max_grad_norm=1e9)
    j_hist, t_hist, js, ts_ = run_both(kw, shapes, None, 4, grad_scale=1e-3)
    for jp, tp in zip(j_hist, t_hist):
        assert_trees_close(tp, jp, rtol=1e-6, atol=1e-8)
    adam = js[1][0]  # chain(clip, adamw8bit) -> ScaleByAdam8bitState
    assert ts_["count"] == int(adam.count) == 4
    for name, want in (("mu", adam.mu), ("nu", adam.nu)):
        got = ts_[name]
        np.testing.assert_allclose(got["small"].numpy(), np.asarray(want["small"]), rtol=1e-6, atol=1e-12)
        q_t, q_j = got["big"]["q"].numpy().astype(np.int32), np.asarray(want["big"]["q"]).astype(np.int32)
        assert got["big"]["q"].dtype == torch.int8
        assert np.abs(q_t - q_j).max() <= 1, name
        assert (q_t == q_j).mean() >= 0.999, name
        np.testing.assert_allclose(got["big"]["scale"].numpy(), np.asarray(want["big"]["scale"]), rtol=1e-6)


def test_should_quantize_threshold():
    assert t8.should_quantize(torch.empty(65536)) and not t8.should_quantize(torch.empty(65535))
    m = t8.init_moment(torch.empty(70_000), signed=False)
    assert m["q"].shape == (35, 2048) and m["q"].dtype == torch.int8 and m["scale"].shape == (35, 1)
    assert t8.init_moment(torch.empty(3, 5), signed=True).dtype == torch.float32


# ---------------------------------------------------------------------------
# stochastic rounding (as tests/test_optim8bit.py::TestStochasticRounding)
# ---------------------------------------------------------------------------

def test_stochastic_rounding_is_unbiased():
    """1000 sub-ulp bf16 updates: round-to-nearest loses them all, stochastic
    rounding accumulates to the right expectation."""
    p = torch.full((4096,), 1.0, dtype=torch.bfloat16)
    u = torch.full((4096,), 1e-4, dtype=torch.float32)  # ulp(1.0) = 7.8e-3
    gen = torch.Generator().manual_seed(0)
    for _ in range(1000):
        p = t8.add_rounded(p, u, gen, stochastic=True)
    assert t8.add_rounded(torch.ones(4096, dtype=torch.bfloat16), u, gen, stochastic=False).float().mean() == 1.0
    got = p.float().mean().item()
    assert abs(got - 1.1) < 0.01, got


def test_stochastic_rounding_leaves_fp32_exact():
    p, u = torch.ones(8), torch.full((8,), 1e-9)
    assert torch.equal(t8.add_rounded(p, u, torch.Generator().manual_seed(0), stochastic=True), p + u)


# ---------------------------------------------------------------------------
# validation metrics
# ---------------------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    gt = rng.uniform(-1, 1, (6, 4, 7)).astype(np.float32)
    pred = (gt + rng.normal(0, 0.15, gt.shape)).astype(np.float32)
    thresholds = [0.05, 0.1, 0.2, 0.3, 0.5]
    want = np.asarray(jmetric.get_action_accuracy(jnp.asarray(gt), jnp.asarray(pred), thresholds))
    got = tmetric.get_action_accuracy(torch.from_numpy(gt), torch.from_numpy(pred), thresholds)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert 0.0 < got[2] < 1.0  # the thresholds split the frames
    np.testing.assert_allclose(tmetric.l1_error(torch.from_numpy(gt), torch.from_numpy(pred)).item(),
                               float(jmetric.l1_error(jnp.asarray(gt), jnp.asarray(pred))), rtol=1e-6)


# ---------------------------------------------------------------------------
# a rank's slice against the whole leaf's blocks (ZeRO-3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape, dim, parts, rows_per_chunk", [
    ((3, 64, 96), 1, 2, t8.ROWS_PER_CHUNK),  # a middle dim: each rank holds whole blocks
    ((3, 64, 96), 2, 4, 1),  # the last dim: 1/4 of each block per rank, chunks of one block row
    ((5, 1152, 8), 1, 4, 3),  # rows of 9216 elements: blocks straddle the rows
    ((4096,), 0, 2, 1),  # one dim, two blocks per rank
    ((7, 100), 1, 1, t8.ROWS_PER_CHUNK),  # one part: the one-rank layout, its tail block short
])
def test_slice_update_is_the_whole_leafs(monkeypatch, shape, dim, parts, rows_per_chunk):
    """Three 8-bit AdamW steps on each rank's slice (the ranks as threads,
    their per-block absmax maxed between them as the all-reduce would): the
    directions, the codes gathered into block rows and the scales are one
    rank's on the whole leaf, bit for bit."""
    import threading

    monkeypatch.setattr(t8, "ROWS_PER_CHUNK", rows_per_chunk)
    torch.manual_seed(0)
    n, width = int(np.prod(shape)), shape[dim] // parts
    whole = {signed: {"q": torch.full((-(-n // t8.BLOCK_SIZE), t8.BLOCK_SIZE), t8.zero_index(signed),
                                      dtype=torch.int8), "scale": torch.zeros(-(-n // t8.BLOCK_SIZE), 1)}
             for signed in (True, False)}
    ranks = [(t8.init_slice_moment(torch.zeros(shape).narrow(dim, 0, width), n, True),
              t8.init_slice_moment(torch.zeros(shape).narrow(dim, 0, width), n, False),
              t8.slice_layout(shape, dim, parts, f)) for f in range(parts)]
    hyper = dict(c1=0.1, c2=0.002, b1=0.9, b2=0.999, eps=1e-8)
    for _ in range(3):
        g = torch.randn(shape) * torch.logspace(-6, 0, shape[-1])  # blocks of mixed magnitude
        want = torch.zeros(n)
        for sl, u in t8.adam8bit_leaf(g, whole[True], whole[False], **hyper):
            want[sl] = u
        barrier, shared, got = threading.Barrier(parts, timeout=60), [None] * parts, [None] * parts

        def rank(f):
            mu, nu, layout = ranks[f]

            def reduce_max(x):
                shared[f] = x.clone()
                barrier.wait()
                x.copy_(torch.stack(shared).amax(dim=0))
                barrier.wait()

            local = g.narrow(dim, f * width, width).contiguous()
            out = torch.zeros(local.numel())
            for sl, u in t8.adam8bit_slice(local, mu, nu, layout, reduce_max, **hyper):
                out[sl] = u
            got[f] = out.view(local.shape)

        threads = [threading.Thread(target=rank, args=(f,)) for f in range(parts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and all(x is not None for x in got)
        assert torch.equal(torch.cat(got, dim).reshape(-1), want)
    for r, signed in ((0, True), (1, False)):
        codes = torch.cat([ranks[f][r]["q"] for f in range(parts)], dim)
        assert torch.equal(t8.slice_to_rows(codes, signed), whole[signed]["q"])
        assert torch.equal(t8.rows_to_slice(whole[signed]["q"], shape), codes)
        assert all(torch.equal(ranks[f][r]["scale"], whole[signed]["scale"]) for f in range(parts))
