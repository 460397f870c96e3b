"""The PyTorch port's int8 (W8A8) serving against the JAX package's, on the CPU.

Inputs come from seeded numpy generators and go through both packages. The
JAX side runs compiled (`jax.jit`), as its serving path does: XLA then turns
the `/ 127.0` of a scale into a multiply by the fp32 reciprocal and contracts
the bias add and the Pallas kernel's chunk fold into fused multiply-adds,
and the port reproduces those steps. Tolerances:
- quantized codes and scales: equal (the port's `kernel_q` is K-major,
  [..., out, in]: it equals the transpose of the reference's [..., in, out]);
- one W8A8 product (per row, or per chunk against the Pallas kernel in
  interpret mode): equal;
- the tiny Pi0 sampler on int8 params: relative L2 2e-2 and max abs 0.1. The
  fp32 ops around the int8 products sum in another order (~1e-6, as in
  tests/test_torch_pi0.py), and an activation within that noise of a
  rounding tie takes the other int8 code: the sampler is discontinuous
  there. Without a flip the two agree to ~3e-6; one flip in the tiny model
  moves the actions by ~1e-2 (the fixture's batch: 2.6e-3 relative L2), as
  a 2e-6 perturbation of the images does within the port alone.
The CUDA kernel's own tests are in tests/test_torch_w8a8_cuda.py, which
imports no JAX, so that it runs on the card machine.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intact_tpu.models import common as jcm
from intact_tpu.models.pi0 import model as jpi0
from intact_tpu.models.pi0.config import Pi0Config as JPi0Config
from intact_tpu.ops.pallas_int8 import w8a8_matmul as j_w8a8
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models.pi0 import model as tpi0
from intact_tpu_torch.models.pi0.config import Pi0Config as TPi0Config
from intact_tpu_torch.ops import w8a8

J32 = jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
T32 = tcm.FP32_POLICY
POLICIES = {
    "fp32": (J32, T32),
    "bf16": (jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.bfloat16),
             tcm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)),
}
SAMPLE_RTOL = 2e-2
SAMPLE_ATOL = 0.1


def t_(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def cfgs():
    return JPi0Config.tiny(), TPi0Config.tiny()


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jpi0.init(jax.random.key(0), cfgs[0])


@pytest.fixture(scope="module")
def jquant(jparams):
    return jax.jit(jcm.quantize_params)(jparams)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

class TestQuantize:
    def test_quantize_params_paths_codes_scales(self, cfgs, jparams, jquant):
        tparams = convert.from_jax_params(numpy_tree(jparams), cfgs[1], device="cpu")
        tq = flat(tcm.quantize_params(tparams))
        jq = flat(numpy_tree(jquant))
        assert set(tq) == set(jq)
        quantized = [k for k in jq if k.endswith("kernel_q")]
        # every transformer-block matmul (siglip 6, gemma 7, expert 7) and img_proj
        assert sorted(quantized) == sorted(
            [f"siglip/blocks/{m}/kernel_q" for m in ("attn/q", "attn/k", "attn/v", "attn/o", "mlp/fc1", "mlp/fc2")]
            + [f"{t}/blocks/{m}/kernel_q" for t in ("vlm", "expert")
               for m in ("attn/q", "attn/k", "attn/v", "attn/o", "mlp/gate", "mlp/up", "mlp/down")]
            + ["img_proj/kernel_q"])
        for k, v in jq.items():
            out = tq[k].numpy()
            if k.endswith("kernel_q"):  # K-major: the transpose of the reference's codes
                out = np.swapaxes(out, -1, -2)
            assert out.dtype == v.dtype and out.shape == v.shape, k
            np.testing.assert_array_equal(out, v, err_msg=k)

    @pytest.mark.parametrize("route", ["quantize_host_tree", "convert"])
    def test_kmajor_codes_are_the_reference_transposed(self, cfgs, jparams, jquant, route):
        """The serving tree's K-major codes, made on the host leaf by leaf or
        carried across from the reference's quantized tree, are the transpose
        of jax.jit(quantize_params)'s, bit for bit, and contiguous."""
        if route == "quantize_host_tree":
            tq = flat(tcm.quantize_host_tree(numpy_tree(jparams), tcm.FP32_POLICY, device="cpu"))
        else:
            tq = flat(convert.from_jax_params(numpy_tree(jquant), cfgs[1], device="cpu"))
        jq = flat(numpy_tree(jquant))
        codes = [k for k in jq if k.endswith("kernel_q")]
        assert codes and set(tq) == set(jq)
        for k in codes:
            assert tq[k].is_contiguous() and tq[k].dtype == torch.int8, k
            np.testing.assert_array_equal(tq[k].numpy(), np.swapaxes(jq[k], -1, -2), err_msg=k)
            np.testing.assert_array_equal(tq[k.replace("kernel_q", "kernel_scale")].numpy(),
                                          jq[k.replace("kernel_q", "kernel_scale")], err_msg=k)

    def test_consume_empties_the_source_tree(self, cfgs, jparams):
        tparams = convert.from_jax_params(numpy_tree(jparams), cfgs[1], device="cpu")
        ref = flat(tcm.quantize_params(tparams))
        out = flat(tcm.quantize_params(tparams, consume=True))
        assert tparams == {} and set(out) == set(ref)
        for k in ref:
            assert torch.equal(out[k], ref[k]), k

    @pytest.mark.parametrize("shape", [(64, 40), (2, 33, 17)])
    def test_quantize_dense_stacked_and_ragged(self, shape):
        rng = np.random.default_rng(2)
        k = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        k[..., 3] = 0.0  # an all-zero output channel takes the 1e-12 floor
        b = rng.standard_normal(shape[:-2] + shape[-1:]).astype(np.float32)
        ref = jax.jit(jcm.quantize_dense)({"kernel": jnp.asarray(k), "bias": jnp.asarray(b)})
        out = tcm.quantize_dense({"kernel": t_(k), "bias": t_(b)})
        assert out["kernel_q"].dtype == torch.int8 and out["kernel_scale"].dtype == torch.float32
        np.testing.assert_array_equal(out["kernel_q"].numpy(), np.swapaxes(np.asarray(ref["kernel_q"]), -1, -2))
        for name in ("kernel_scale", "bias"):
            np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]), err_msg=name)

    def test_quantize_embed_and_the_lm_embed_pattern(self):
        rng = np.random.default_rng(3)
        table = (rng.standard_normal((50, 24)) * 0.02).astype(np.float32)
        tree = {"lm": {"embed": {"embedding": table}}, "vlm_embed": {"embedding": table}}
        ref = numpy_tree(jax.jit(jcm.quantize_params)(jax.tree.map(jnp.asarray, tree)))
        out = tcm.quantize_params(tcm.tree_map(t_, tree))
        assert set(out["lm"]["embed"]) == {"embedding_q", "embed_scale"}
        assert set(out["vlm_embed"]) == {"embedding"}  # pi0's table stays fp
        for name in ("embedding_q", "embed_scale"):
            np.testing.assert_array_equal(out["lm"]["embed"][name].numpy(), ref["lm"]["embed"][name])


# ---------------------------------------------------------------------------
# one W8A8 product
# ---------------------------------------------------------------------------

class TestDenseInt8:
    @pytest.mark.parametrize("lead", [(5,), (2, 3)], ids=["2d", "3d"])
    @pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
    @pytest.mark.parametrize("dt", ["fp32", "bf16"])
    @pytest.mark.parametrize("k,n", [(37, 53), (300, 77)])
    def test_matches_jax(self, lead, use_bias, dt, k, n):
        rng = np.random.default_rng(k * n)
        w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
        node = {"kernel": w}
        if use_bias:
            node["bias"] = rng.standard_normal(n).astype(np.float32)
        x = rng.standard_normal((*lead, k)).astype(np.float32)
        jpol, tpol = POLICIES[dt]
        jq = jax.jit(jcm.quantize_dense)(jax.tree.map(jnp.asarray, node))
        tq = tcm.quantize_dense(tcm.tree_map(t_, node))
        ref = jax.jit(functools.partial(jcm._dense_int8, policy=jpol))(jq, jnp.asarray(x).astype(jpol.compute_dtype))
        out = tcm.dense(tq, t_(x).to(tpol.compute_dtype), tpol)
        assert out.dtype == tpol.compute_dtype and out.shape == (*lead, n)
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))

    @pytest.mark.parametrize("m,k,n", [(5, 384, 77), (33, 384, 200), (17, 300, 130)])
    @pytest.mark.parametrize("dt", ["fp32", "bf16"])
    def test_per_chunk_matches_pallas_interpret(self, m, k, n, dt):
        rng = np.random.default_rng(m + k + n)
        x = rng.standard_normal((m, k)).astype(np.float32)
        x[:, 130:140] *= 20.0  # one chunk's scale far from the others'
        q = jax.jit(jcm.quantize_dense)({"kernel": jnp.asarray((rng.standard_normal((k, n)) * 0.05).astype(np.float32))})
        jdt, tdt = (jnp.float32, torch.float32) if dt == "fp32" else (jnp.bfloat16, torch.bfloat16)
        ref = j_w8a8(jnp.asarray(x).astype(jdt), q["kernel_q"], q["kernel_scale"], interpret=True, block_k=128)
        args = (t_(x).to(tdt), t_(q["kernel_q"]), t_(q["kernel_scale"]))
        out = w8a8.w8a8_matmul_reference(*args, k_chunk=128)
        assert out.dtype == tdt
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))
        # the wrapper takes the plain version for CPU tensors, and per-row
        # quantization differs from per-chunk here (K = 3 chunks)
        assert torch.equal(w8a8.w8a8_matmul(*args, k_chunk=128), out)
        assert not torch.equal(w8a8.w8a8_matmul(*args), out)
        # ... and the K-major layout gives the same product
        nk = (args[0], args[1].t().contiguous(), args[2])
        assert torch.equal(w8a8.w8a8_matmul(*nk, k_chunk=128, weight_layout="nk"), out)

    def test_chunk_length(self):
        assert w8a8.chunk_length(16384, None) is None
        assert w8a8.chunk_length(16384, 2048) == 2048
        assert w8a8.chunk_length(300, 2048) == 384  # Pallas: min(block_k, round_up(K, 128))
        with pytest.raises(ValueError, match="multiple of 64"):
            w8a8.chunk_length(300, 100)

    @pytest.mark.parametrize("m,n,k,k_chunk", [
        (5, 2048, 1024, None), (5, 1024, 4096, None), (320, 2048, 1024, None), (320, 1024, 4096, None),
        (320, 1024, 4096, 2048), (5, 1024, 4096, 128), (45, 200, 1000, 128), (45, 200, 1000, 192),
        (77, 131, 300, None), (20992, 16384, 2048, None), (20992, 2048, 16384, 2048),
    ])
    def test_plan_covers_k_and_split_sums_are_exact(self, m, n, k, k_chunk):
        """The planner's K split covers K_pad in whole pipeline stages, holds
        whole chunks per split in per-chunk semantics, splits only where the
        output tiles leave the card idle, and the split's int32 partial sums
        (the kernel's workspace, in plain torch) add up to the unsplit ones."""
        p = w8a8.plan(m, n, k, k_chunk)
        k_pad = -(-k // 64) * 64
        chunk = w8a8.chunk_length(k, k_chunk)
        tiles = -(-m // 128) * -(-n // w8a8.BLOCK_N["row" if chunk is None else "chunk"])
        assert (p.mode == "split") == (tiles < w8a8.NUM_SMS and p.n_splits > 1)
        if p.mode != "split":
            assert p == (("row" if chunk is None else "chunk"), k_pad, 1)
            return
        assert p.split_len % w8a8.STAGE_K == 0 and (chunk is None or p.split_len % chunk == 0)
        assert (p.n_splits - 1) * p.split_len < k_pad <= p.n_splits * p.split_len
        rng = np.random.default_rng(m + n + k)
        nn = min(n, 24)  # 3 rows and a narrow slice of the columns keep the check fast
        xq = t_(rng.integers(-127, 128, (3, k)).astype(np.int8))
        wq = t_(rng.integers(-127, 128, (k, nn)).astype(np.int8))
        part = w8a8.split_partials(xq, wq, k_chunk, p)
        c = chunk or k_pad
        assert part.dtype == torch.int32 and part.shape == (-(-k // c), 3, nn)
        for i in range(part.shape[0]):
            whole = xq[:, i * c:(i + 1) * c].to(torch.int64) @ wq[i * c:(i + 1) * c].to(torch.int64)
            assert torch.equal(part[i].to(torch.int64), whole)

    def test_wrapper_checks_refuse_what_the_kernels_do_not_take(self):
        from intact_tpu_torch.ops import flash_attention as fa

        x = torch.zeros(4, 64, dtype=torch.bfloat16)
        ws = torch.ones(8)
        for wq, layout, exc in [
            (torch.zeros(64, 8, dtype=torch.int8), "kn_", ValueError),  # unknown layout
            (torch.zeros(64, 8), "kn", TypeError),  # not int8
            (torch.zeros(1, 64, 8, dtype=torch.int8), "kn", TypeError),  # not 2-D
            (torch.zeros(64, 8, dtype=torch.int8), "nk", ValueError),  # [N, K] read as [8, 64]: K mismatch
            (torch.zeros(64, 16, dtype=torch.int8)[:, ::2], "kn", ValueError),  # [K, N] not contiguous
            (torch.zeros(64, 16, dtype=torch.int8).t()[::2], "nk", ValueError),  # [N, K] rows not contiguous
        ]:
            with pytest.raises(exc):
                w8a8._check(x, wq, ws, None, torch.bfloat16, layout)
        wq = torch.zeros(8, 64, dtype=torch.int8)
        w8a8._check(x, wq, ws, None, torch.bfloat16, "nk")
        with pytest.raises(TypeError, match="bf16 or fp32"):
            w8a8._check(x.half(), wq, ws, None, torch.bfloat16, "nk")
        with pytest.raises(ValueError, match=r"\[N\]"):
            w8a8._check(x, wq, torch.ones(9), None, torch.bfloat16, "nk")
        # codes the kernel reads as they are, and K-major copies of the others
        assert w8a8.kmajor(wq, "nk") == (wq, 64)
        w, stride = w8a8.kmajor(torch.arange(300 * 8, dtype=torch.int32).to(torch.int8).reshape(300, 8), "kn")
        assert w.shape == (8, 304) and stride == 304 and not w[:, 300:].any()
        assert torch.equal(w[:, :300], torch.arange(300 * 8, dtype=torch.int32).to(torch.int8).reshape(300, 8).t())
        # flash attention: bf16, head_dim 64/128/256, a query group dividing 64
        q = torch.zeros(1, 4, 8, 64, dtype=torch.bfloat16)
        kv = torch.zeros(1, 4, 1, 64, dtype=torch.bfloat16)
        fa._check(q, kv, kv, None)
        for args, exc in [((q.float(), kv.float(), kv.float(), None), TypeError),
                          ((q[..., :32], kv[..., :32], kv[..., :32], None), ValueError),
                          ((torch.zeros(1, 4, 6, 64, dtype=torch.bfloat16), torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16),
                            torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16), None), ValueError),  # G = 3
                          ((q, kv, kv, torch.ones(1, 4, 5, dtype=torch.bool)), ValueError)]:
            with pytest.raises(exc):
                fa._check(*args)

    def test_embed_lookup_and_unembed_logits(self):
        rng = np.random.default_rng(5)
        table = (rng.standard_normal((40, 24)) * 0.02).astype(np.float32)
        ids = np.array([[0, 5, 39, 41], [3, -1, 7, 7]], np.int32)  # out-of-range ids clip
        hidden = rng.standard_normal((2, 3, 24)).astype(np.float32)
        jq = jax.jit(jcm.quantize_embed)({"embedding": jnp.asarray(table)})
        tq = tcm.quantize_embed({"embedding": t_(table)})
        for jpol, tpol in POLICIES.values():
            ref = jax.jit(functools.partial(jcm.embed_lookup, policy=jpol))(jq, jnp.asarray(ids))
            out = tcm.embed_lookup(tq, t_(ids), tpol)
            np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))
        ref = jax.jit(jcm.unembed_logits)(jq, jnp.asarray(hidden))
        out = tcm.unembed_logits(tq, t_(hidden))
        assert out.dtype == torch.float32 and out.shape == (2, 3, 40)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# the slice: quantized Pi0 sampling
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batch(cfgs):
    cfg = cfgs[0]
    rng = np.random.default_rng(1)
    b, s = 2, cfg.vision.image_size
    lang_masks = np.zeros((b, cfg.tokenizer_max_length), bool)
    lang_masks[0, :5] = True
    lang_masks[1, :3] = True
    return {
        "images": rng.uniform(-1, 1, (b, cfg.num_cameras, s, s, 3)).astype(np.float32),
        "img_masks": np.ones((b, cfg.num_cameras), bool),
        "lang_tokens": rng.integers(0, 300, (b, cfg.tokenizer_max_length)).astype(np.int32),
        "lang_masks": lang_masks,
        "state": rng.standard_normal((b, cfg.max_state_dim), dtype=np.float32),
        "noise": rng.standard_normal((b, cfg.chunk_size, cfg.max_action_dim), dtype=np.float32),
    }


KEYS = ("images", "img_masks", "lang_tokens", "lang_masks", "state")


class TestQuantizedSampling:
    @pytest.mark.parametrize("route", ["jax_quantized", "port_quantized"])
    def test_sample_actions_matches_jax(self, cfgs, jparams, jquant, batch, route):
        jc, tc = cfgs
        ref = jax.jit(functools.partial(jpi0.sample_actions, cfg=jc, policy=J32))(
            jquant, None, *(jnp.asarray(batch[k]) for k in KEYS), noise=jnp.asarray(batch["noise"]))
        if route == "jax_quantized":  # the JAX tree quantized, then carried across
            tparams = convert.from_jax_params(numpy_tree(jquant), tc, device="cpu")
            assert tparams["vlm"]["blocks"]["mlp"]["up"]["kernel_q"].dtype == torch.int8
        else:  # the port quantizing the carried-across fp tree
            tparams = tcm.quantize_params(convert.from_jax_params(numpy_tree(jparams), tc, device="cpu"))
        out = tpi0.sample_actions(tparams, None, *(t_(batch[k]) for k in KEYS), tc, T32,
                                  noise=t_(batch["noise"]))
        assert out.shape == (2, tc.chunk_size, tc.max_action_dim) and torch.isfinite(out).all()
        ref = np.asarray(ref)
        assert np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref) < SAMPLE_RTOL
        assert np.abs(out.numpy() - ref).max() < SAMPLE_ATOL

    def test_policy_quantize_counts_one_product_per_block_matmul(self, cfgs, jparams, batch, monkeypatch):
        """Pi0Policy(quantize=True) sends every transformer-block matmul and
        img_proj through the W8A8 wrapper: per inference, vision depth x 6 +
        1 + (vlm depth - 1) x 7 + 2 + num_steps x expert depth x 7 calls."""
        from intact_tpu_torch.models.pi0.policy import Pi0Policy

        tc = cfgs[1]
        calls = []
        real = w8a8.w8a8_matmul

        def counting(*args, **kwargs):
            calls.append(args[1].shape)
            return real(*args, **kwargs)

        monkeypatch.setattr(w8a8, "w8a8_matmul", counting)
        policy = Pi0Policy(tc, seed=0, tokenizer_path="hash", use_bf16=False, device="cpu", quantize=True)
        obs = {"image": np.zeros((1, tc.vision.image_size, tc.vision.image_size, 3), np.uint8),
               "state": np.zeros((1, 7), np.float32), "task": ["pick"]}
        chunk = policy.sample_action_chunk(obs)
        want = (tc.vision.depth * 6 + 1 + (tc.vlm.depth - 1) * 7 + 2 + tc.num_steps * tc.expert.depth * 7)
        assert len(calls) == want and np.isfinite(chunk).all()

    def test_int8_close_to_fp(self, cfgs, jparams, batch):
        """The int8 sampler stays near the fp one (W8A8 rounding through
        2+2 tiny layers and 3 Euler steps)."""
        tc = cfgs[1]
        fp = convert.from_jax_params(numpy_tree(jparams), tc, device="cpu")
        args = [t_(batch[k]) for k in KEYS]
        ref = tpi0.sample_actions(fp, None, *args, tc, T32, noise=t_(batch["noise"]))
        out = tpi0.sample_actions(tcm.quantize_params(fp), None, *args, tc, T32, noise=t_(batch["noise"]))
        assert ((out - ref).norm() / ref.norm()).item() < 0.05


def test_config_quantize_default_pattern_is_the_reference_one():
    assert tcm.QUANTIZE_DEFAULT_PATTERN == jcm.QUANTIZE_DEFAULT_PATTERN
    assert tcm.UNEMBED_QUANT_PATTERN == jcm.UNEMBED_QUANT_PATTERN
    assert dataclasses.asdict(JPi0Config.tiny()) == dataclasses.asdict(TPi0Config.tiny())
