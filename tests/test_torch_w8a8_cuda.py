"""The W8A8 CUDA kernel (csrc/w8a8_matmul.cu) against its plain version, on the card.

Marked `cuda`: each test skips inside a fixture where there is no CUDA device
(the kernel has no CPU mode). The file imports no JAX, so it runs on a
machine with a card and PyTorch alone: `python -m pytest --noconftest
tests/test_torch_w8a8_cuda.py -q` (tests/conftest.py sets up JAX).

Tolerance: codes and scales equal; outputs within one bf16 ulp of the row's
largest |y|, because the plain version forms its fused multiply-adds in
float64 and may round once more than the kernel where a value lands on an
fp32 tie (about 2^-29 of values).
"""

import numpy as np
import pytest
import torch

from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.ops import w8a8

ROW_RTOL = 2.0**-8


def t_(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the W8A8 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestW8A8Kernel:
    @pytest.mark.parametrize("m,k,n,k_chunk,dt,layout", [
        (5, 1024, 2048, None, torch.bfloat16, "nk"),  # a batch-1 expert decode: split K
        (5, 4096, 1024, None, torch.bfloat16, "nk"),  # ... its down projection: 32 splits
        (320, 1024, 2048, None, torch.bfloat16, "nk"),  # the expert q projection at batch 64: split K
        (320, 4096, 1024, None, torch.bfloat16, "nk"),  # the expert down projection at batch 64
        (320, 4096, 1024, 2048, torch.bfloat16, "nk"),  # ... per 2048-chunk: one chunk per split
        (5, 4096, 1024, 128, torch.float32, "kn"),  # split per 128-chunk, [K, N] codes
        (257, 4304, 1152, None, torch.bfloat16, "nk"),  # SigLIP fc2: ragged K
        (257, 4304, 1152, 2048, torch.bfloat16, "kn"),  # ... per 2048-chunk (Pallas semantics)
        (130, 1152, 4304, None, torch.bfloat16, "nk"),  # SigLIP fc1: ragged N
        (2100, 2048, 4304, None, torch.bfloat16, "nk"),  # 128 x 256 tiles (row mode), ragged N
        (2100, 4304, 2048, 2048, torch.bfloat16, "nk"),  # 128 x 128 tiles (chunk mode), mid-stage chunk ends
        (2100, 1000, 1100, 192, torch.float32, "kn"),  # chunk mode, chunks of 192 ending mid-stage
        (77, 300, 131, None, torch.float32, "kn"),  # ragged everything, fp32, odd N
        (45, 1000, 200, 128, torch.float32, "nk"),  # 8 chunks of 128, K not a multiple of 16
        (1, 64, 8, None, torch.bfloat16, "nk"),  # one tile, one row
    ])
    def test_kernel_matches_reference(self, cuda, m, k, n, k_chunk, dt, layout):
        rng = np.random.default_rng(m + k + n)
        x = t_(rng.standard_normal((m, k), dtype=np.float32)).to(cuda, dt)
        wq = t_(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(cuda)
        ws = t_((rng.random(n) + 0.5).astype(np.float32) * 1e-3).to(cuda)
        bias = t_(rng.standard_normal(n).astype(np.float32)).to(cuda)
        w_in = wq if layout == "kn" else wq.t().contiguous()
        for b in (None, bias):
            before = w8a8.w8a8_matmul.launches
            y, xq, xs = w8a8.launch(x, w_in, ws, b, k_chunk, dt, layout)
            torch.cuda.synchronize()
            assert w8a8.w8a8_matmul.launches == before + 1
            rq, rs = w8a8.quantize_reference(x, k_chunk)
            assert torch.equal(xq[:, :k], rq) and not xq[:, k:].any() and torch.equal(xs, rs)
            ref = w8a8.w8a8_matmul_reference(x, wq, ws, b, k_chunk, dt)
            tol = ROW_RTOL * ref.float().abs().amax(dim=1, keepdim=True)
            assert ((y.float() - ref.float()).abs() <= tol).all()

    def test_dense_on_cuda_launches_the_kernel(self, cuda):
        rng = np.random.default_rng(0)
        node = tcm.quantize_dense({"kernel": t_((rng.standard_normal((128, 64)) * 0.05).astype(np.float32)).to(cuda)})
        x = t_(rng.standard_normal((3, 7, 128), dtype=np.float32)).to(cuda, torch.bfloat16)
        before = w8a8.w8a8_matmul.launches
        y = tcm.dense(node, x, tcm.SERVING_POLICY)
        assert w8a8.w8a8_matmul.launches == before + 1 and y.shape == (3, 7, 64)
        ref = w8a8.w8a8_matmul_reference(x, node["kernel_q"].t(), node["kernel_scale"], out_dtype=torch.bfloat16)
        assert torch.equal(y, ref)

    @pytest.mark.parametrize("m,n", [(64, 33922), (1, 33922), (64, 4098)])
    def test_int8_unembedding_launches_the_kernel(self, cuda, m, n):
        """The tied unembedding's shape at a reduced vocabulary: K 2304, N = 2
        mod 8 (fp32 rows not 16-byte aligned: the stores from registers) and
        130 live columns in the last 256-wide tile, as at N = 259,714; 133
        tiles keep the row mode of the full shape, N 4098 takes the split
        mode. Bit-equal to the plain version: without a bias each output is
        round(round(float(sum) * xs) * ws) on both sides."""
        rng = np.random.default_rng(n + m)
        table = tcm.quantize_embed({"embedding": t_((rng.standard_normal((n, 2304)) * 0.02).astype(np.float32))
                                    .to(cuda)})
        assert n % 8 == 2 and n % 256 == 130 or w8a8.plan(m, n, 2304).mode == "split"
        hidden = t_(rng.standard_normal((m, 2304), dtype=np.float32)).to(cuda, torch.bfloat16)
        before = w8a8.w8a8_matmul.launches
        y = tcm.unembed_logits(table, hidden, tcm.SERVING_POLICY)
        torch.cuda.synchronize()
        assert w8a8.w8a8_matmul.launches == before + 1 and y.dtype == torch.float32 and y.shape == (m, n)
        ref = w8a8.w8a8_matmul_reference(hidden, table["embedding_q"].t(), table["embed_scale"], out_dtype=torch.float32)
        assert torch.equal(y, ref)

    @pytest.mark.parametrize("m", [64, 1])
    def test_llama_down_projection_splits_k(self, cuda, m):
        """A LLaMA-3-8B decode step's down projection, K 14,336 (the largest K
        of any path; per-row int32 sums up to 127^2 x 14,336 < 2^31): the split
        plan over many STAGE_K units, the quantize pass's absmax over 14,336
        values, bit-equal to the plain version (no bias)."""
        k, n = 14_336, 4096
        p = w8a8.plan(m, n, k)
        assert p.mode == "split" and p.split_len % w8a8.STAGE_K == 0 and p.split_len // w8a8.STAGE_K > 4
        rng = np.random.default_rng(m)
        x = t_(rng.standard_normal((m, k), dtype=np.float32)).to(cuda, torch.bfloat16)
        wq = t_(rng.integers(-127, 128, (n, k)).astype(np.int8)).to(cuda)
        ws = t_((rng.random(n) + 0.5).astype(np.float32) * 1e-3).to(cuda)
        before = w8a8.w8a8_matmul.launches
        y, xq, xs = w8a8.launch(x, wq, ws, None, None, torch.bfloat16, "nk")
        torch.cuda.synchronize()
        assert w8a8.w8a8_matmul.launches == before + 1
        rq, rs = w8a8.quantize_reference(x)
        assert torch.equal(xq[:, :k], rq) and torch.equal(xs, rs)
        assert torch.equal(y, w8a8.w8a8_matmul_reference(x, wq.t(), ws, out_dtype=torch.bfloat16))

    @pytest.mark.parametrize("m", [64, 1])
    def test_untied_lm_head_launches_the_kernel(self, cuda, m):
        """Magma's untied lm_head through `llama.logits`: K 4096, N 128,256,
        bf16 out (rows 16-byte aligned: the TMA-store epilogue; 501 tiles keep
        the row plan at M 1 too), cast to fp32 after the product; bit-equal
        to the plain version."""
        from intact_tpu_torch.models import llama

        cfg = llama.llama3_8b()
        k, n = cfg.width, cfg.vocab_size
        rng = np.random.default_rng(n + m)
        head = {"kernel_q": t_(rng.integers(-127, 128, (n, k)).astype(np.int8)).to(cuda),
                "kernel_scale": t_((rng.random(n) + 0.5).astype(np.float32) * 1e-3).to(cuda)}
        hidden = t_(rng.standard_normal((m, k), dtype=np.float32)).to(cuda, torch.bfloat16)
        before = w8a8.w8a8_matmul.launches
        y = llama.logits({"lm_head": head}, hidden, cfg, tcm.SERVING_POLICY)
        torch.cuda.synchronize()
        assert w8a8.w8a8_matmul.launches == before + 1 and y.dtype == torch.float32 and y.shape == (m, n)
        ref = w8a8.w8a8_matmul_reference(hidden, head["kernel_q"].t(), head["kernel_scale"], out_dtype=torch.bfloat16)
        assert torch.equal(y, ref.float())

    def test_kernel_raises_on_fp16(self, cuda):
        wq = torch.zeros(64, 8, dtype=torch.int8, device=cuda)
        with pytest.raises(TypeError, match="bf16 or fp32"):
            w8a8.w8a8_matmul(torch.zeros(2, 64, dtype=torch.float16, device=cuda), wq, torch.ones(8, device=cuda))
