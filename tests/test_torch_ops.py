"""The PyTorch port's ops against the JAX package's, on the CPU in fp32.

Inputs come from a seeded numpy generator and go through both packages.
Tolerances: fp32 ops that sum in another order agree to ~1e-6 relative;
2e-5 leaves room for the softmax's exp. bf16 cases allow 2 bf16 ulps at
|x| ~ 1 (2e-2). The row update's plain version is held to the Pallas kernel in
interpret mode at 1e-6 relative (the same fp32 operations; XLA may contract
a multiply-add), with equal fp8 codes; its stochastic rounding is held bit for
bit to the reference's hash-noise path. The CUDA kernels themselves are held
to their plain versions on the card (marked `cuda`; skipped where there is
no CUDA device).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intact_tpu.ops import attention as jattn
from intact_tpu.ops import pallas_adam
from intact_tpu.ops.masks import make_att_2d_masks as j_masks
from intact_tpu.ops.pallas_attention import flash_attention as j_flash
from intact_tpu.ops.rope import apply_rope as j_rope
from intact_tpu.train import fused_joint as jfj
from intact_tpu.train.optim import OptimizerConfig as JOpt
from intact_tpu_torch.ops import attention as tattn
from intact_tpu_torch.ops import fused_adam as tadam
from intact_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
from intact_tpu_torch.ops.masks import make_att_2d_masks as t_masks
from intact_tpu_torch.ops.rope import apply_rope as t_rope
from intact_tpu_torch.train import fused_joint as tfj
from intact_tpu_torch.train.optim import OptimizerConfig as TOpt

ATOL = RTOL = 2e-5
BF16_ATOL = 2e-2


def qkv(rng, b, t, s, h, kvh, d):
    return (rng.standard_normal((b, t, h, d), dtype=np.float32),
            rng.standard_normal((b, s, kvh, d), dtype=np.float32),
            rng.standard_normal((b, s, kvh, d), dtype=np.float32))


def ragged_mask(rng, b, t, s):
    mask = rng.random((b, t, s)) > 0.3
    mask[:, :, s - 3:] = False  # key padding
    mask[:, ::5] = False  # fully masked query rows
    return mask


def t_(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class TestMasksRope:
    def test_masks_match(self):
        rng = np.random.default_rng(0)
        pad = rng.random((3, 11)) > 0.2
        att = (rng.random((3, 11)) > 0.6).astype(np.int32)
        np.testing.assert_array_equal(
            t_masks(t_(pad), t_(att)).numpy(), np.asarray(j_masks(jnp.asarray(pad), jnp.asarray(att))))

    def test_masks_reject_3d(self):
        with pytest.raises(ValueError, match="2D"):
            t_masks(torch.ones(1, 2, 3, dtype=torch.bool), torch.zeros(1, 2, 3, dtype=torch.int32))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_rope_matches(self, dtype):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
        pos = rng.integers(0, 400, (2, 7)).astype(np.int32)
        ref = np.asarray(j_rope(jnp.asarray(x, dtype), jnp.asarray(pos)), np.float32)
        out = t_rope(t_(x).to(getattr(torch, dtype)), t_(pos)).float().numpy()
        # fp32 angles up to ~400 rad: sin/cos of large arguments differ in
        # the last bits between libraries
        tol = 1e-4 if dtype == "float32" else BF16_ATOL
        np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


class TestPlainAttention:
    @pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 1)])
    @pytest.mark.parametrize("masked", [False, True])
    def test_xla_attention_matches(self, h, kvh, masked):
        rng = np.random.default_rng(2)
        q, k, v = qkv(rng, 2, 9, 13, h, kvh, 16)
        mask = ragged_mask(rng, 2, 9, 13) if masked else None
        ref = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  None if mask is None else jnp.asarray(mask), 0.3)
        out = tattn.xla_attention(t_(q), t_(k), t_(v), None if mask is None else t_(mask), 0.3)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)

    @pytest.mark.parametrize("h,kvh", [(8, 1), (4, 4), (8, 2)])
    def test_cached_matches(self, h, kvh):
        rng = np.random.default_rng(3)
        b, t, s1, s2, d = 2, 5, 37, 5, 16
        q = rng.standard_normal((b, t, h, d), dtype=np.float32)
        kc, vc = (rng.standard_normal((b, s1, kvh, d), dtype=np.float32) for _ in range(2))
        kn, vn = (rng.standard_normal((b, s2, kvh, d), dtype=np.float32) for _ in range(2))
        mask = np.ones((b, t, s1 + s2), bool)
        mask[:, :, s1 - 3:s1] = False
        mask[0, :2, s1 + 1:] = False
        args = (q, kc, vc, kn, vn, mask[:, :, :s1], mask[:, :, s1:])
        ref = jattn.xla_attention_cached(*map(jnp.asarray, args))
        out = tattn.xla_attention_cached(*map(t_, args))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
        # and equal to attention over the concatenated K/V
        full = tattn.xla_attention(t_(q), t_(np.concatenate([kc, kn], 1)),
                                   t_(np.concatenate([vc, vn], 1)), t_(mask))
        np.testing.assert_allclose(out.numpy(), full.numpy(), atol=ATOL, rtol=RTOL)

    def test_unknown_impl_raises(self):
        x = torch.zeros(1, 2, 1, 4)
        with pytest.raises(ValueError, match="unknown attention impl"):
            tattn.multi_head_attention(x, x, x, impl="flex")


class TestFlashReference:
    """The kernel's plain version against the Pallas kernel in interpret mode."""

    @pytest.mark.parametrize("t,s,h,kvh,d", [
        (37, 53, 2, 2, 64),    # ragged, MHA
        (20, 45, 4, 2, 64),    # ragged, group 2
        (13, 29, 8, 1, 128),   # ragged, group 8 (the Pi0 layout)
    ])
    def test_matches_pallas_interpret(self, t, s, h, kvh, d):
        rng = np.random.default_rng(4)
        q, k, v = qkv(rng, 2, t, s, h, kvh, d)
        mask = ragged_mask(rng, 2, t, s)
        ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(mask), interpret=True))
        out = flash_attention_reference(t_(q), t_(k), t_(v), t_(mask)).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
        # fully masked rows are 0 in both (a plain softmax would average V)
        dead = ~mask.any(-1)
        assert dead.any()
        np.testing.assert_array_equal(out[dead], 0.0)
        np.testing.assert_array_equal(ref[dead], 0.0)

    def test_live_rows_match_plain_attention(self):
        rng = np.random.default_rng(5)
        q, k, v = qkv(rng, 2, 11, 17, 8, 1, 32)
        mask = ragged_mask(rng, 2, 11, 17)
        out = flash_attention_reference(t_(q), t_(k), t_(v), t_(mask), 0.2).numpy()
        plain = tattn.xla_attention(t_(q), t_(k), t_(v), t_(mask), 0.2).numpy()
        live = mask.any(-1)
        np.testing.assert_allclose(out[live], plain[live], atol=ATOL, rtol=RTOL)
        assert not np.allclose(plain[~live], 0.0)  # the two differ on dead rows on purpose

    def test_bf16_inputs(self):
        rng = np.random.default_rng(6)
        q, k, v = qkv(rng, 1, 40, 40, 2, 1, 64)
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        ref = np.asarray(j_flash(jq, jk, jv, None, interpret=True), np.float32)
        out = flash_attention_reference(*(t_(x).bfloat16() for x in (q, k, v)))
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), ref, atol=BF16_ATOL)

    def test_cpu_dispatch_uses_reference_and_counts_nothing(self):
        rng = np.random.default_rng(7)
        q, k, v = (t_(x) for x in qkv(rng, 1, 6, 6, 2, 1, 16))
        before = flash_attention.launches
        out = tattn.multi_head_attention(q, k, v, None, impl="pallas")
        np.testing.assert_array_equal(out.numpy(), flash_attention_reference(q, k, v).numpy())
        assert flash_attention.launches == before


ADAM_KW = dict(lr=1e-3, weight_decay=1e-4, warmup_steps=2, first_cycle_steps=100, max_grad_norm=1e9)
JOPT, TOPT = JOpt(**ADAM_KW), TOpt(**ADAM_KW)


def jnp_to_torch(x) -> torch.Tensor:
    """A JAX/ml_dtypes array -> torch tensor of the same bits."""
    x = np.asarray(x)
    views = {"float8_e4m3fn": (np.uint8, torch.float8_e4m3fn), "float8_e5m2": (np.uint8, torch.float8_e5m2),
             "bfloat16": (np.int16, torch.bfloat16)}
    if x.dtype.name in views:
        raw, dt = views[x.dtype.name]
        return torch.from_numpy(np.ascontiguousarray(x).view(raw).copy()).view(dt)
    return torch.from_numpy(np.array(x))


def bits(x) -> np.ndarray:
    """The raw bits of a torch or JAX array, for bit-for-bit comparisons."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]).numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.int16, 4: np.int32}[x.dtype.itemsize])


def moment_rows(rng, shape, fp8: bool, signed: bool):
    """(codes or fp32 moments, fp32 row scales [..., NB]) as JAX arrays."""
    x = rng.standard_normal(shape).astype(np.float32) * 0.1
    if not signed:
        x = np.abs(x)
    if not fp8:
        return jnp.asarray(x), jnp.zeros(shape[:-1], jnp.float32)
    dt, cap = (jnp.float8_e4m3fn, 448.0) if signed else (jnp.float8_e5m2, 57344.0)
    scale = np.maximum(np.abs(x).max(-1, keepdims=True) / cap, np.finfo(np.float32).tiny).astype(np.float32)
    return jnp.asarray(x / scale).astype(dt), jnp.asarray(scale[..., 0])


class TestFusedAdamReference:
    """The kernel's plain version against the Pallas kernel in interpret mode."""

    @pytest.mark.parametrize("mode", ["fp8", "exact"])
    def test_matches_pallas_interpret(self, mode):
        rng = np.random.default_rng(10)
        L, r, B, NB, off, layer = 3, 128, 256, 512, 128, 1
        p = jnp.asarray(rng.standard_normal((L, r, B), dtype=np.float32))
        g = jnp.asarray(rng.standard_normal((r, B), dtype=np.float32) * 0.01)
        qm, sm = moment_rows(rng, (L, NB, B), mode == "fp8", True)
        qn, sn = moment_rows(rng, (L, NB, B), mode == "fp8", False)
        hyp = np.array([0.5, 0.75, 1e-3, 0.8], np.float32)
        ref = pallas_adam.fused_adam_rows(
            p, g, qm, sm, qn, sn, layer=layer, seed=7, c1=jnp.float32(hyp[0]), c2=jnp.float32(hyp[1]),
            lr=jnp.float32(hyp[2]), clip_factor=jnp.float32(hyp[3]), hp=JOPT, row_offset=off,
            stochastic=False, interpret=True)
        before = [jnp_to_torch(x) for x in (p, g, qm, sm, qn, sn)]
        out = [x.clone() for x in before]
        ss = torch.zeros(1)
        launches = tadam.fused_adam_rows.launches
        tadam.fused_adam_rows(*out, layer=layer, row_offset=off, hyp=torch.from_numpy(hyp), ss=ss, hp=TOPT)
        assert tadam.fused_adam_rows.launches == launches  # a CPU tensor runs the plain version

        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-6, atol=1e-6)
        rows = slice(off, off + r)
        for i, j in ((2, 1), (4, 3)):
            if mode == "fp8":
                np.testing.assert_array_equal(bits(out[i][layer, rows]), bits(ref[j][layer, rows]))
            else:
                np.testing.assert_allclose(out[i][layer, rows].numpy(), np.asarray(ref[j][layer, rows]),
                                           rtol=1e-6, atol=1e-9)
        for i, j in ((3, 2), (5, 4)):
            np.testing.assert_allclose(out[i][layer, rows].numpy(), np.asarray(ref[j][layer, rows]), rtol=1e-6)
        np.testing.assert_allclose(ss.item(), float(ref[5]), rtol=1e-5)
        # in place: every other layer, and the rows outside [off, off + r) of `layer`, untouched
        for o, b in zip(out, before):
            for other in (0, 2):
                np.testing.assert_array_equal(bits(o[other]), bits(b[other]))
        for i in (2, 3, 4, 5):
            np.testing.assert_array_equal(bits(out[i][layer, :off]), bits(before[i][layer, :off]))
            np.testing.assert_array_equal(bits(out[i][layer, off + r:]), bits(before[i][layer, off + r:]))

    def test_eligibility_matches(self):
        for n, blk in ((128 * 2048, 2048), (2048, 2048), (2047 * 128, 2048), (16384 * 2048, 2048), (8 * 128, 8)):
            assert tadam.eligible(n, blk) == pallas_adam.eligible(n, blk)

    def test_bad_shapes_raise(self):
        p, g = torch.zeros(2, 128, 256), torch.zeros(128, 256)
        m, s = torch.zeros(2, 256, 256), torch.zeros(2, 256)
        kw = dict(layer=0, hyp=torch.ones(4), ss=torch.zeros(1), hp=TOPT)
        with pytest.raises(ValueError, match="outside"):
            tadam.fused_adam_rows(p, g, m, s, m.clone(), s.clone(), row_offset=256, **kw)
        with pytest.raises(ValueError, match="moments"):
            tadam.fused_adam_rows(p, g, m[:, :, :8], s, m[:, :, :8], s, row_offset=0, **kw)


class TestFusedAdamWrapper:
    """The wrapper's host side, on the CPU."""

    def test_workspace_is_cached_per_device_and_stream(self):
        a = tadam.workspace(torch.device("cpu"), 7)
        assert tadam.workspace(torch.device("cpu"), 7) is a
        b = tadam.workspace(torch.device("cpu"), 8)
        assert b is not a and b[0] is not a[0] and b[1] is not a[1]
        partials, ticket = a
        assert partials.shape == (tadam.MAX_CTAS,) and partials.dtype == torch.float32
        assert ticket.dtype == torch.int32 and ticket.tolist() == [0]

    def test_fp32_params_run_the_plain_version_on_the_cpu(self):
        """fp32 p and g (the fp32-master case the kernel now takes) go
        through the plain version on CPU tensors and count no launch; the
        result matches the bf16-free update of fused_rows_update."""
        rng = np.random.default_rng(14)
        L, r, B, NB, off, layer = 2, 128, 256, 384, 128, 1
        p = torch.from_numpy(rng.standard_normal((L, r, B), dtype=np.float32) * 0.02)
        g = torch.from_numpy(rng.standard_normal((r, B), dtype=np.float32) * 1e-3)
        qm, sm = (jnp_to_torch(x) for x in moment_rows(rng, (L, NB, B), True, True))
        qn, sn = (jnp_to_torch(x) for x in moment_rows(rng, (L, NB, B), True, False))
        hyp = torch.tensor([0.1, 0.001, 1e-3, 0.9])
        out = [x.clone() for x in (p, g, qm, sm, qn, sn)]
        launches = tadam.fused_adam_rows.launches
        tadam.fused_adam_rows(*out, layer=layer, row_offset=off, hyp=hyp, ss=torch.zeros(1), hp=TOPT,
                              stochastic=True)
        assert tadam.fused_adam_rows.launches == launches and out[0].dtype == torch.float32
        rows = slice(off, off + r)
        want = tadam.fused_rows_update(p[layer], g, qm[layer, rows], sm[layer, rows, None], qn[layer, rows],
                                       sn[layer, rows, None], c1=hyp[0], c2=hyp[1], lr=hyp[2], clip_factor=hyp[3],
                                       hp=TOPT, salt=0, stochastic=True, scale_mode="exact")
        np.testing.assert_array_equal(bits(out[0][layer]), bits(want[0]))
        np.testing.assert_array_equal(bits(out[2][layer, rows]), bits(want[1]))

    def test_math_check_needs_the_card(self):
        with pytest.raises(ValueError, match="CUDA"):
            tadam.math_check(torch.ones(4), torch.ones(4), "divide")


class TestStochasticRounding:
    """SR with a uint32 salt: bit for bit the reference's hash-noise path."""

    @pytest.mark.parametrize("shape", [(37, 64), (5, 3), (300,)])
    def test_hash_noise_matches(self, shape):
        for salt in (0, 12345, 0xFFFFFFFF):
            ref = np.asarray(jfj._hash_noise_u16(shape, jnp.uint32(salt)))
            np.testing.assert_array_equal(tadam.hash_noise_u16(shape, salt).numpy(), ref)

    @pytest.mark.parametrize("shape", [(64, 96), (300,)])
    def test_sr_add_bit_for_bit(self, shape):
        rng = np.random.default_rng(11)
        p = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        upd = rng.standard_normal(shape).astype(np.float32) * 1e-3
        ref = jfj._sr_add(p, jnp.asarray(upd), jnp.uint32(987654321), True)
        out = tfj._sr_add(jnp_to_torch(p), torch.from_numpy(upd), 987654321, True)
        np.testing.assert_array_equal(bits(out), bits(ref))

    def test_row_update_bit_for_bit(self):
        """The kernel's plain version with SR == _fused_rows_update(stochastic,
        scale_mode="exact") with a uint32 salt: params, codes and scales."""
        rng = np.random.default_rng(12)
        r, B, salt = 128, 256, 123456789
        p = jnp.asarray(rng.standard_normal((r, B)), jnp.bfloat16)
        g = jnp.asarray(rng.standard_normal((r, B)) * 0.1, jnp.bfloat16)
        qm, sm = moment_rows(rng, (r, B), True, True)
        qn, sn = moment_rows(rng, (r, B), True, False)
        hyp = np.array([0.1, 0.001, 1e-2, 0.9], np.float32)
        ref = jfj._fused_rows_update(
            p, g, qm, sm[:, None], qn, sn[:, None], c1=jnp.float32(hyp[0]), c2=jnp.float32(hyp[1]),
            lr=jnp.float32(hyp[2]), clip_factor=jnp.float32(hyp[3]), hp=JOPT, key=jnp.uint32(salt),
            stochastic=True, scale_mode="exact")
        out = [jnp_to_torch(x)[None].clone() for x in (p,)] + [jnp_to_torch(g)] + [
            jnp_to_torch(x)[None].clone() for x in (qm, sm, qn, sn)]
        ss = torch.zeros(1)
        tadam.fused_adam_rows(*out, layer=0, row_offset=0, hyp=torch.from_numpy(hyp), ss=ss, hp=TOPT,
                              salt=salt, stochastic=True)
        for o, want in ((out[0][0], ref[0]), (out[2][0], ref[1]), (out[4][0], ref[3])):
            np.testing.assert_array_equal(bits(o), bits(want))
        for o, want in ((out[3][0], ref[2][:, 0]), (out[5][0], ref[4][:, 0])):
            np.testing.assert_array_equal(o.numpy(), np.asarray(want))
        # and SR did something: not the round-to-nearest result everywhere
        rn = [jnp_to_torch(x)[None].clone() for x in (p,)] + [jnp_to_torch(g)] + [
            jnp_to_torch(x)[None].clone() for x in (qm, sm, qn, sn)]
        tadam.fused_adam_rows(*rn, layer=0, row_offset=0, hyp=torch.from_numpy(hyp), ss=ss, hp=TOPT)
        assert (bits(rn[0]) != bits(out[0])).any()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestFlashKernel:
    @pytest.mark.parametrize("b,t,s,h,kvh,d", [
        (2, 328, 328, 8, 1, 256),  # the serving shape, G = 8
        (1, 328, 328, 8, 1, 256),  # batch 1: 21 blocks of 128 rows
        (16, 333, 333, 8, 1, 256),  # the training shape: mask rows of 333 bytes
        (3, 77, 203, 8, 8, 128),  # G = 1
        (2, 33, 95, 4, 2, 64),  # G = 2
        (2, 70, 130, 8, 2, 128),  # G = 4
    ])
    def test_kernel_matches_reference(self, cuda, b, t, s, h, kvh, d):
        rng = np.random.default_rng(8)
        q, k, v = (t_(x).to(cuda, torch.bfloat16) for x in qkv(rng, b, t, s, h, kvh, d))
        mask = t_(ragged_mask(rng, b, t, s)).to(cuda)
        before = flash_attention.launches
        out = flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref = flash_attention_reference(q, k, v, mask)
        np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), atol=BF16_ATOL)
        dead = ~mask.any(dim=-1)  # fully masked query rows give exact 0
        assert dead.any() and not out[dead].any()

    def test_kernel_raises_on_fp32(self, cuda):
        x = torch.zeros(1, 4, 1, 64, device=cuda)
        with pytest.raises(TypeError, match="bf16"):
            flash_attention(x, x, x)


@pytest.mark.cuda
class TestFusedAdamKernel:
    @pytest.mark.parametrize("fp8", [True, False])
    @pytest.mark.parametrize("stochastic", [True, False])
    def test_kernel_matches_reference(self, cuda, fp8, stochastic):
        rng = np.random.default_rng(13)
        L, r, B, NB, off, layer = 3, 256, 2048, 640, 128, 1
        p = torch.from_numpy(rng.standard_normal((L, r, B), dtype=np.float32) * 0.02).to(cuda, torch.bfloat16)
        g = torch.from_numpy(rng.standard_normal((r, B), dtype=np.float32) * 1e-3).to(cuda, torch.bfloat16)
        moments = [jnp_to_torch(x).to(cuda) for signed in (True, False) for x in moment_rows(rng, (L, NB, B), fp8, signed)]
        args = [p, g, *moments]
        kern, ref = [x.clone() for x in args], [x.clone() for x in args]
        hyp = torch.tensor([0.1, 0.001, 1e-3, 0.9], device=cuda)
        kw = dict(layer=layer, row_offset=off, hyp=hyp, hp=TOPT, salt=77, stochastic=stochastic)
        ss_k, ss_r = torch.zeros(1, device=cuda), torch.zeros(1, device=cuda)
        before = tadam.fused_adam_rows.launches
        tadam.fused_adam_rows(*kern, ss=ss_k, **kw)
        torch.cuda.synchronize()
        assert tadam.fused_adam_rows.launches == before + 1
        tadam.fused_adam_rows_reference(*ref, ss=ss_r, **kw)
        # the kernel repeats the plain version's fp32 operations (no fused
        # multiply-adds): p bit-equal, codes at most one apart (torch's CUDA
        # divides by a scalar through its reciprocal), scales to 1e-6
        np.testing.assert_array_equal(bits(kern[0].cpu()), bits(ref[0].cpu()))
        for i in (2, 4):
            if fp8:
                a, b = (x.view(torch.uint8).to(torch.int32).cpu().numpy() for x in (kern[i], ref[i]))
                a, b = (np.where(x >= 128, 128 - x, x) for x in (a, b))
                assert np.abs(a - b).max() <= 1
            else:
                np.testing.assert_allclose(kern[i].cpu().numpy(), ref[i].cpu().numpy(), rtol=1e-6)
        for i in (3, 5):
            np.testing.assert_allclose(kern[i].cpu().numpy(), ref[i].cpu().numpy(), rtol=1e-6)
        np.testing.assert_allclose(ss_k.item(), ss_r.item(), rtol=1e-5)
        for k, o in zip(kern, args):
            assert torch.equal(k[:layer], o[:layer]) and torch.equal(k[layer + 1:], o[layer + 1:])

    def test_kernel_raises_on_fp16_params(self, cuda):
        p, g = (torch.zeros(*shape, device=cuda, dtype=torch.float16) for shape in ((1, 128, 256), (128, 256)))
        m, s = torch.zeros(1, 128, 256, device=cuda), torch.zeros(1, 128, device=cuda)
        with pytest.raises(TypeError, match="bf16 or fp32"):
            tadam.fused_adam_rows(p, g, m, s, m.clone(), s.clone(), layer=0, row_offset=0,
                                  hyp=torch.ones(4, device=cuda), ss=torch.zeros(1, device=cuda), hp=TOPT)
