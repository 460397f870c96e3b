"""The 8-bit AdamW row-update CUDA kernel (csrc/fused_adam_rows.cu) against its plain version, on the card.

Marked `cuda`: each test skips inside a fixture where there is no CUDA device
(the kernel has no CPU mode). The file imports no JAX, so it runs on a
machine with a card and PyTorch alone: `python -m pytest --noconftest
tests/test_torch_adam_cuda.py -q` (tests/conftest.py sets up JAX).

Tolerances, each with its reason: p bit-equal (the kernel repeats the plain
version's correctly rounded fp32 operations one by one, with no fused
multiply-adds, and the same SR noise); fp8 codes at most one code apart and
scales within 1e-6 relative (the plain version divides the row maximum by
448 as a multiply by torch's fp32 reciprocal, which may move a scale by one
fp32 ulp and with it a code across a rounding boundary); fp32 moments
within 1e-6 relative; ss within 1e-5 relative (the same squares summed in
another order); every row, layer and scale outside the leaf's bit-identical.
"""

import pytest
import torch

from intact_tpu_torch.ops import fused_adam as fa
from intact_tpu_torch.train.optim import OptimizerConfig

HP = OptimizerConfig(lr=5e-5, weight_decay=1e-2)
HYP = (1 - 0.9**3, 1 - 0.999**3, 5e-5, 0.7)  # c1, c2 at step 3, lr, clip
SCALE_RTOL = 1e-6
SS_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the row-update kernel has no CPU mode")
    return torch.device("cuda")


def make_case(seed, L, r, NB, B, p_dtype, fp8):
    """p, g and moments at the magnitudes of a training step (p ~ 0.02,
    g ~ 1e-3, mu ~ 1e-3, nu ~ 1e-12), drawn on the card from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device="cuda").mul_(std)

    p, g = randn(L, r, B, std=0.02).to(p_dtype), randn(r, B, std=1e-3).to(p_dtype)
    mu, nu = randn(L, NB, B, std=1e-3), randn(L, NB, B, std=1e-6).square_()
    if not fp8:
        return [p, g, mu, torch.zeros(L, NB, device="cuda"), nu, torch.zeros(L, NB, device="cuda")]
    out = [p, g]
    for x, dt, cap in ((mu, torch.float8_e4m3fn, 448.0), (nu, torch.float8_e5m2, 57344.0)):
        s = x.abs().amax(-1) / cap
        out += [(x / s[..., None]).to(dt), s]
    return out


def fp8_index(codes: torch.Tensor) -> torch.Tensor:
    """fp8 codes (sign-magnitude bytes) -> integers ordered like their values."""
    u = codes.view(torch.uint8).to(torch.int32)
    return torch.where(u >= 128, -(u - 128), u)


def run_both(args, *, layer, row_offset, stochastic, salt=987654321, calls=1):
    """The kernel (through the wrapper) and the plain version on copies of
    args: -> (kernel tensors, plain tensors, kernel ss, plain ss). With
    calls > 1 the plain version's last call starts from the kernel's state
    (a code one apart would otherwise carry into p); ss accumulates every
    call on both sides."""
    hyp = torch.tensor(HYP, device="cuda")
    kern = [x.clone() for x in args]
    ss_k, ss_r = torch.zeros(1, device="cuda"), torch.zeros(1, device="cuda")
    kw = dict(layer=layer, row_offset=row_offset, hyp=hyp, hp=HP, salt=salt, stochastic=stochastic)
    for c in range(calls):
        ref = [x.clone() for x in (kern if c == calls - 1 else args)]
        before = fa.fused_adam_rows.launches
        fa.fused_adam_rows(*kern, ss=ss_k, **kw)
        torch.cuda.synchronize()
        assert fa.fused_adam_rows.launches == before + 1
        fa.fused_adam_rows_reference(*ref, ss=ss_r, **kw)
    return kern, ref, ss_k, ss_r


def check(args, kern, ref, ss_k, ss_r, *, layer, row_offset, skip_p=None):
    """The file's tolerances; NaN wherever the plain version has NaN.
    skip_p: a boolean mask of p elements left out of the bit comparison."""
    r = args[0].shape[1]
    rows = slice(row_offset, row_offset + r)
    pk, pr = kern[0][layer], ref[0][layer]
    same = pk.view(torch.int16 if pk.dtype == torch.bfloat16 else torch.int32) == pr.view(
        torch.int16 if pr.dtype == torch.bfloat16 else torch.int32)
    if skip_p is not None:
        same |= skip_p
    assert bool(same.all()), f"p differs in {int((~same).sum())} elements"
    fp8 = args[2].dtype != torch.float32
    for i in (2, 4):
        k, f = kern[i][layer, rows], ref[i][layer, rows]
        nan_k, nan_f = torch.isnan(k.float()), torch.isnan(f.float())
        assert torch.equal(nan_k, nan_f)
        if fp8:
            assert (fp8_index(k) - fp8_index(f))[~nan_f].abs().max().item() <= 1
        else:
            torch.testing.assert_close(k, f, rtol=SCALE_RTOL, atol=0.0, equal_nan=True)
    for i in (3, 5):
        torch.testing.assert_close(kern[i][layer, rows], ref[i][layer, rows], rtol=SCALE_RTOL, atol=0.0, equal_nan=True)
    torch.testing.assert_close(ss_k, ss_r, rtol=SS_RTOL, atol=0.0, equal_nan=True)
    assert torch.equal(kern[1].view(torch.uint8), args[1].view(torch.uint8))  # g is read only
    for i in (0, 2, 3, 4, 5):
        k, o = kern[i], args[i]
        assert torch.equal(k[:layer], o[:layer]) and torch.equal(k[layer + 1:], o[layer + 1:])
    for i in (2, 3, 4, 5):
        assert torch.equal(kern[i][layer, :row_offset], args[i][layer, :row_offset])
        assert torch.equal(kern[i][layer, row_offset + r:], args[i][layer, row_offset + r:])


@pytest.mark.cuda
class TestFusedAdamRowsKernel:
    # every distinct trunk leaf shape of the bridge step (rows of 2048):
    # expert k/v 128, VLM k/v 256, expert q/o 1024, expert MLP and VLM q/o
    # 2048, VLM MLP 16384 (the Gemma-2B gate leaf, at its offset in the pack)
    # (two layers of the pack: the row range and the layer index are what
    # address the leaf)
    @pytest.mark.parametrize("r,L,NB,row_offset,layer", [
        (128, 2, 10496, 0, 1),
        (256, 2, 57344, 256, 0),
        (1024, 2, 10496, 1408, 1),
        (2048, 2, 10496, 4480, 1),
        (16384, 2, 57344, 20992, 1),
    ])
    @pytest.mark.parametrize("stochastic", [True, False])
    def test_leaf_shapes_fp8(self, cuda, r, L, NB, row_offset, layer, stochastic):
        args = make_case(r, L, r, NB, 2048, torch.bfloat16, True)
        out = run_both(args, layer=layer, row_offset=row_offset, stochastic=stochastic)
        check(args, *out, layer=layer, row_offset=row_offset)

    # rows that are not a multiple of the persistent grid, a leaf in the
    # middle of the pack, every p and moment dtype, block sizes below 2048
    @pytest.mark.parametrize("p_dtype,fp8,stochastic,B", [
        (torch.bfloat16, True, True, 2048),
        (torch.bfloat16, False, True, 2048),
        (torch.bfloat16, False, False, 2048),
        (torch.float32, True, False, 2048),
        (torch.float32, False, False, 2048),
        (torch.float32, True, True, 2048),  # SR asked with fp32 p: rounds nothing, as the Pallas kernel
        (torch.bfloat16, True, True, 256),
        (torch.bfloat16, True, False, 768),
        (torch.float32, True, False, 1024),
    ])
    def test_dtypes_and_ragged_grid(self, cuda, p_dtype, fp8, stochastic, B):
        L, r, NB, off, layer = 3, 1280 + 128, 4096, 384, 1
        args = make_case(B + r, L, r, NB, B, p_dtype, fp8)
        out = run_both(args, layer=layer, row_offset=off, stochastic=stochastic)
        check(args, *out, layer=layer, row_offset=off)

    @pytest.mark.parametrize("p_dtype,stochastic", [(torch.bfloat16, True), (torch.bfloat16, False),
                                                    (torch.float32, False)])
    def test_zero_row_and_nan(self, cuda, p_dtype, stochastic):
        """An all-zero gradient row over all-zero moments (scales at the
        FLT_MIN floor, the exact division's path) and one NaN gradient
        element (its row's scales, codes and ss turn NaN; the other p stay
        bit-equal)."""
        L, r, NB, B, off, layer = 2, 1280, 2048, 2048, 256, 1
        args = make_case(7, L, r, NB, B, p_dtype, True)
        args[1][3].zero_()
        args[2][layer, off + 3].zero_()
        args[4][layer, off + 3].zero_()
        args[1][7, 100] = float("nan")
        kern, ref, ss_k, ss_r = run_both(args, layer=layer, row_offset=off, stochastic=stochastic)
        nan_at = torch.zeros(r, B, dtype=torch.bool, device="cuda")
        nan_at[7, 100] = True
        check(args, kern, ref, ss_k, ss_r, layer=layer, row_offset=off, skip_p=nan_at)
        assert torch.isnan(ss_k).all() and torch.isnan(kern[3][layer, off + 7])
        assert kern[3][layer, off + 3].item() == torch.finfo(torch.float32).tiny
        assert kern[5][layer, off + 3].item() == torch.finfo(torch.float32).tiny
        assert not kern[2][layer, off + 3].view(torch.uint8).any()

    @pytest.mark.parametrize("share", [1.0, 0.1])
    def test_elements_that_never_had_a_gradient(self, cuda, share):
        """Zero gradients over zero moments, for the whole leaf (as the VLM's
        last layer in the joint step, whose output no loss reads: the
        kernel's zero path) or for a tenth of the elements scattered through
        it (zeros among data: the exact path): p stays bit-equal."""
        L, r, NB, B, off, layer = 2, 2048, 4096, 2048, 1024, 1
        args = make_case(17, L, r, NB, B, torch.bfloat16, True)
        gen = torch.Generator(device="cuda").manual_seed(18)
        zero = torch.rand(r, B, generator=gen, device="cuda") < share
        args[1][zero] = 0.0
        for i in (2, 4):
            rows = args[i][layer, off:off + r]
            rows.view(torch.uint8)[zero] = 0
        out = run_both(args, layer=layer, row_offset=off, stochastic=True)
        check(args, *out, layer=layer, row_offset=off)
        if share == 1.0:
            assert not out[0][2][layer, off:off + r].view(torch.uint8).any()
            assert (out[0][3][layer, off:off + r] == torch.finfo(torch.float32).tiny).all()

    def test_two_calls_reuse_the_workspace(self, cuda):
        """Back to back on the cached partials and ticket: ss accumulates
        both calls, and the second call's last CTA finds the ticket re-armed."""
        args = make_case(11, 2, 1280, 2048, 2048, torch.bfloat16, True)
        ws = fa.workspace(torch.device("cuda", torch.cuda.current_device()), torch.cuda.current_stream().cuda_stream)
        out = run_both(args, layer=1, row_offset=256, stochastic=True, calls=2)
        check(args, *out, layer=1, row_offset=256)
        ws2 = fa.workspace(torch.device("cuda", torch.cuda.current_device()), torch.cuda.current_stream().cuda_stream)
        assert ws2[0] is ws[0] and ws2[1] is ws[1] and ws[1].item() == 0

    def test_fast_paths_are_correctly_rounded(self, cuda):
        """The kernel's fast division (hoisted reciprocal), square root and
        direction (mu/c1) / (sqrt(nu/c2) + eps) equal __fdiv_rn and
        __fsqrt_rn in every bit wherever the kernel takes them: random pairs
        over the whole range it accepts, operands with all-ones mantissas,
        values a row scale times an fp8 code (near the codes' rounding
        boundaries), and moments at training magnitudes and at the range's
        ends, with zeros of both signs among the dividends and moments."""
        gen = torch.Generator(device="cuda").manual_seed(3)
        n = 1 << 22

        def exp2(lo, hi):
            return torch.exp2(torch.randint(lo, hi, (n,), generator=gen, device="cuda").float())

        def uniform():
            return torch.rand(n, generator=gen, device="cuda")

        ones = torch.randint(0x3FFFF000, 0x40000000, (n,), generator=gen, device="cuda", dtype=torch.int32)
        s = uniform().add_(0.5) * exp2(-50, -5)
        pairs = [
            ((uniform() * 2 - 1) * exp2(-61, 62), (uniform() + 1) * exp2(-61, 62)),
            (torch.randn(n, generator=gen, device="cuda") * exp2(-40, 0), (uniform() + 1) * exp2(-30, 0)),
            (ones.view(torch.float32) * exp2(-59, 59), uniform() + 0.5),
            (torch.randn(n, generator=gen, device="cuda"), ones.view(torch.float32) * exp2(-59, 59)),
            (s * torch.randint(-896, 897, (n,), generator=gen, device="cuda").float() * 0.5, s),
        ]
        def with_zeros(x):  # a tenth of the values +0 or -0, as moments that never had a gradient
            zero = uniform() < 0.1
            return torch.where(zero, torch.where(uniform() < 0.5, 0.0, -0.0), x)

        for a, d in pairs:
            for mode, x in (("divide", with_zeros(a)), ("sqrt", a.abs())):
                tested, wrong = fa.math_check(x, d, mode)
                assert tested > n // 2 and wrong == 0, (mode, tested, wrong)
        for c1, c2, eps in ((0.1, 0.001, 1e-8), HYP[:2] + (1e-8,), (1.0, 1.0, 1e-6), (2.0**-30, 2.0**-30, 2.0**-60)):
            for scale in (1e-3, 1e-9, 2.0**-55, 2.0**12):
                m = with_zeros(torch.randn(n, generator=gen, device="cuda") * scale)
                v = with_zeros(torch.randn(n, generator=gen, device="cuda").square() * scale**2 + uniform() * scale)
                tested, wrong = fa.math_check(m, v, "direction", c1, c2, eps)
                assert tested > n // 2 and wrong == 0, (c1, c2, eps, scale, tested, wrong)

    @pytest.mark.parametrize("p_dtype,g_dtype", [(torch.float16, torch.float16), (torch.float32, torch.bfloat16)])
    def test_kernel_raises_on_other_dtypes(self, cuda, p_dtype, g_dtype):
        p, g = torch.zeros(1, 128, 256, device=cuda, dtype=p_dtype), torch.zeros(128, 256, device=cuda, dtype=g_dtype)
        m, s = torch.zeros(1, 128, 256, device=cuda), torch.zeros(1, 128, device=cuda)
        with pytest.raises(TypeError, match="bf16 or fp32"):
            fa.fused_adam_rows(p, g, m, s, m.clone(), s.clone(), layer=0, row_offset=0,
                               hyp=torch.ones(4, device=cuda), ss=torch.zeros(1, device=cuda), hp=HP)
