"""The PyTorch port's ops against the JAX package's, on the CPU in fp32.

Inputs come from a seeded numpy generator and go through both packages.
Tolerances: fp32 ops that sum in another order agree to ~1e-6 relative;
2e-5 leaves room for the softmax's exp. bf16 cases allow 2 bf16 ulps at
|x| ~ 1 (2e-2). The CUDA kernel itself is held to its plain version on the
card (marked `cuda`; skipped where there is no CUDA device).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intact_tpu.ops import attention as jattn
from intact_tpu.ops.masks import make_att_2d_masks as j_masks
from intact_tpu.ops.pallas_attention import flash_attention as j_flash
from intact_tpu.ops.rope import apply_rope as j_rope
from intact_tpu_torch.ops import attention as tattn
from intact_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
from intact_tpu_torch.ops.masks import make_att_2d_masks as t_masks
from intact_tpu_torch.ops.rope import apply_rope as t_rope

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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestFlashKernel:
    @pytest.mark.parametrize("b,t,s,h,kvh,d", [
        (2, 328, 328, 8, 1, 256),
        (3, 77, 203, 8, 8, 128),
        (2, 33, 95, 4, 2, 64),
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

    def test_kernel_raises_on_fp32(self, cuda):
        x = torch.zeros(1, 4, 1, 64, device=cuda)
        with pytest.raises(TypeError, match="bf16"):
            flash_attention(x, x, x)
