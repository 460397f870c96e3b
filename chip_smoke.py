"""Drive the PyTorch port's main path on one CUDA card and hold its kernels to their plain versions.

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit):
  1. build   compile every CUDA kernel of the path from csrc/ (nvcc, sm_90a)
  2. kernels each kernel against its plain PyTorch version on the card, at the
             main path's shapes and at ragged ones, with timings and bounds
             (flash_attention at the serving shape at batch 64 and 1 and at
             the training shape, each beside SDPA; w8a8_matmul on K-major
             codes at every bridge shape, per row and per 2048-chunk, beside
             torch._int_mm on its codes and the bf16 matmul it replaces, with
             effective rates and device time per call; fused_adam_rows at
             the Gemma-2B gate leaf in fp8 with and without SR, fp32 moments,
             fp32 p and g, and two calls back to back, its fast division and
             square root bit for bit against the correctly rounded ones, its
             SASS instructions per element, device time, wrapper host time,
             and the gate leaf with fp32 p)
  3. serving full-width Pi0 bridge (SigLIP So400m + Gemma-2B + 300M expert,
             random bf16 weights from a seed): requests through
             Pi0Policy.select_action at batch 1 with a reset, and a batch-64
             sample_action_chunk; checks the kernel launch counts, the action
             shapes and finiteness, and the actions against the plain-attention
             path on the same params and noise; then latency at batch 1 and 64,
             and one torch.profiler pass each (device busy share, top kernels)
  3b. int8   the server role's Pi0PolicyWrapper from
             config/experiment/simpler/pi0_finetune_bridge_ev.yaml with
             quantize_int8 on (the bf16 phase's random weights, quantized):
             fused requests through infer_batch at batch 1 and 64, with the
             launches of both serving kernels per inference checked (1544
             w8a8_matmul, 17 flash_attention at the bridge); env actions finite
             and of the right shape; the actions bit-equal with only the
             W8A8 product plain, and within ACTIONS_RTOL of the plain path;
             int8 against bf16 (reported); peak memory; latency and profiles
             beside the same wrapper with quantize_int8 off (bf16)
  4. training the 1-chip joint recipe (config/train/pi0_finetune_bridge_1chip.yaml:
             fused step, bf16 params with stochastic rounding, fp8 moments,
             batch 16, synthetic data) at full width and depth through the
             Trainer: every step's loss and grad_norm finite and its launches
             of both kernels as expected; median step time, samples/s, peak
             memory and a profiler pass (the row update's device time per
             step); every distinct row-update leaf shape timed alone beside
             its bound, summed over the step's launches; one step through the
             kernels against one through their plain versions at full width,
             4 layers; and two steps with fp32 masters (master_dtype float32)
             through the Trainer, the row kernel launched on fp32 p and g
The second-to-last line is `nvidia-smi`'s card name and power limit; the last
line is {"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))

DEVICE = "cuda"
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
# the kernel and its plain version round at different places (bf16 P, bf16
# output, fp32 sums in another order): 2 bf16 ulps at |out| ~ 1
KERNEL_ATOL = 2e-2
# relative L2 distance between bf16 actions from the kernel path and the plain
# path: the two round q*scale and the logits at different places in 17 layers,
# and 10 Euler steps carry that through the expert (bf16 rounding is 2^-9)
ACTIONS_RTOL = 5e-2
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
# fused_adam_rows: bytes each element must move (p read+write 2+2, g 2, the two
# fp8 codes read+write 1+1 each) and its fp32 operations (decode 2, clip 1,
# g*g and the ss sum 2, the two moments 7, direction 5, decay and update 4,
# two absmax 2, encode 2)
ADAM_BYTES_PER_ELEM = 10
ADAM_FLOPS_PER_ELEM = 25
ADAM_ELEMS_PER_THREAD = 16  # csrc/fused_adam_rows.cu: two 8-element octets per thread and row (B = 2048)
# the kernel repeats the plain version's fp32 operations one by one (no fused
# multiply-adds) and sums ss in another order: scales (one division of equal
# maxima) agree to an fp32 ulp, ss (16 M squares) to 1e-5
ADAM_SCALE_RTOL = 1e-6
ADAM_SS_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10, kernel: str | None = None) -> float:
    """Device milliseconds of one call of fn: the summed time of the kernels
    it launches, under torch.profiler, over reps calls. Unlike cuda_ms it
    excludes the host's time between the launches, which bounds a call of
    small kernels from an eager host. With `kernel`, for a call that launches
    that one kernel: its mean time over the launches the profiler recorded
    (late in a long run the profiler has been seen to drop kernel records,
    which the plain sum over reps would count as time not taken)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernel is None:
        return sum(e.self_device_time_total for e in events) / reps / 1e3
    ours = [e for e in events if kernel in e.key]
    count = sum(e.count for e in ours)
    if count != reps:
        log(f"#   device_ms: the profiler recorded {count} of {reps} launches of {kernel}")
    return sum(e.self_device_time_total for e in ours) / max(count, 1) / 1e3


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from intact_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.build_all()
    log(f"# build: {time.perf_counter() - t0:.2f} s for {len(build.SOURCES)} source(s)")
    for name, text in build.ptxas_logs.items():
        entry = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line or "setmaxnreg" in line:
                log(f"# ptxas {name} {entry[:96]}: {line.strip()}")
    # dynamic shared memory, which ptxas does not report
    attn, w8 = build.load("flash_attention"), build.load("w8a8_matmul")
    log(f"# dynamic shared memory per block: attn_kernel D=64/128/256 "
        f"{[attn.intact_flash_attention_smem_bytes(d) for d in (64, 128, 256)]} bytes; w8a8 gemm_kernel "
        f"row/chunk/split {[w8.intact_w8a8_smem_bytes(m) for m in (0, 1, 2)]} bytes")
    log(f"# card: {gpu_name_and_power()}")


def sass_fast_path(so: Path, symbol: str) -> tuple[int, dict]:
    """SASS instructions one thread issues in one pass of the row loop of
    the kernel whose mangled name contains `symbol`, on the path every
    element takes when the operands are in range: from cuobjdump's listing,
    walking from the loop head (the backward branch around the first
    mbarrier wait) to the loop's back-edge; conditional forward branches skip
    the slow paths of the rounded operations and thread 0's ring refill, and
    otherwise fall through (both octets valid); other backward branches (wait loops) are not taken. The
    fast path itself calls nothing, so a forward branch over a CALL skips a
    slow path.
    -> (instructions, {opcode: count})."""
    from intact_tpu_torch.ops import build

    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], check=True, capture_output=True, text=True,
                          timeout=120).stdout
    return count_fast_path(text, symbol)


def count_fast_path(text: str, symbol: str) -> tuple[int, dict]:
    """sass_fast_path on a cuobjdump -sass listing."""
    import re
    from collections import Counter

    ins = None
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        if symbol in part.split("\n")[0]:
            ins = [(int(m.group(1), 16), m.group(2).strip())
                   for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", part)]
            break
    if not ins:
        raise SystemExit(f"no SASS for {symbol}")
    at = {a: i for i, (a, _) in enumerate(ins)}
    branch = re.compile(r"\bBRA(\.\S+)?\s+(?:!?U?P\d,\s*)?0x([0-9a-f]+)")
    wait = next(a for a, t in ins if "SYNCS.PHASECHK" in t)
    back = [(a, int(m.group(2), 16)) for a, t in ins if (m := branch.search(t)) and int(m.group(2), 16) <= a]
    end, head = max(((a, tg) for a, tg in back if tg <= wait < a), key=lambda x: x[0] - x[1])
    i, n, ops = at[head], 0, Counter()
    while True:
        a, t = ins[i]
        n += 1
        ops[re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]] += 1
        m = branch.search(t)
        if a == end or n > 20000:
            break
        if not m:
            i += 1
            continue
        target = int(m.group(2), 16)
        if not t.startswith("@"):
            i = at[target]
        elif target <= a:
            i += 1
        else:
            skipped = " ".join(x for _, x in ins[i + 1:at[target]])
            i = at[target] if "CALL" in skipped or "UBLKCP" in skipped else i + 1
    return n, dict(ops)


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def prefix_mask(b: int, n_img: int, n_lang: int, rng: np.random.Generator) -> torch.Tensor:
    """The Pi0 prefix mask: every valid image token, a ragged number of
    valid language tokens per row, one full-attention block."""
    from intact_tpu_torch.ops.masks import make_att_2d_masks

    pad = np.zeros((b, n_img + n_lang), bool)
    pad[:, :n_img] = True
    for i, n in enumerate(rng.integers(4, n_lang + 1, size=b)):
        pad[i, n_img:n_img + n] = True
    pad = torch.from_numpy(pad).cuda()
    return make_att_2d_masks(pad, torch.zeros_like(pad, dtype=torch.int32))


def attention_case(rng, b, t, s, h, kvh, d, dtype, mask):
    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)

    return rnd(b, t, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d), mask


def phase_kernels() -> list[dict]:
    from intact_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    rng = np.random.default_rng(0)
    # bridge: 256 image + 72 language tokens, 8 query heads over 1 KV head
    b, t, h, kvh, d = 64, 328, 8, 1, 256
    bridge = attention_case(rng, b, t, t, h, kvh, d, torch.bfloat16, prefix_mask(b, 256, 72, rng))
    cases = {"bridge": bridge}
    for name, (b_, t_, s_, h_, kvh_, d_, dt) in {
        "ragged_g1_d128": (3, 77, 203, 8, 8, 128, torch.bfloat16),
        "ragged_g8_d256": (2, 45, 150, 8, 1, 256, torch.bfloat16),
        "ragged_g2_d64": (2, 33, 95, 4, 2, 64, torch.bfloat16),
    }.items():
        mask = torch.from_numpy(rng.random((b_, t_, s_)) > 0.3).cuda()
        mask[:, ::7] = False  # fully masked query rows
        cases[name] = attention_case(rng, b_, t_, s_, h_, kvh_, d_, dt, mask)

    max_err = 0.0
    for name, (q, k, v, mask) in cases.items():
        out = flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v, mask)
        err = (out.float() - ref.float()).abs().max().item()
        dead = ~mask.any(dim=-1)  # [B, T] rows that attend nothing
        dead_max = out[dead].abs().max().item() if dead.any() else 0.0
        log(f"# flash_attention {name}: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} "
            f"max_abs_err {err:.3e} (atol {KERNEL_ATOL}), fully masked rows {int(dead.sum())} max |out| {dead_max}")
        if not torch.isfinite(out).all() or err > KERNEL_ATOL or dead_max != 0.0:
            raise SystemExit(f"flash_attention disagrees with its plain version on {name}")
        max_err = max(max_err, err)

    # the serving shape at batch 64 and 1, and the training forward's shape
    # (batch 16, 77 language tokens: 333-byte mask rows), each beside SDPA
    timed = {"bridge": bridge}
    for name, (b_, n_lang) in {"batch1": (1, 72), "train": (16, 77)}.items():
        timed[name] = attention_case(rng, b_, 256 + n_lang, 256 + n_lang, h, kvh, d, torch.bfloat16,
                                     prefix_mask(b_, 256, n_lang, rng))
    times = {}
    for name, (q, k, v, mask) in timed.items():
        b_, t_, s_ = q.shape[0], q.shape[1], k.shape[1]
        out = flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        err = (out.float() - flash_attention_reference(q, k, v, mask).float()).abs().max().item()
        if name != "bridge" and (err > KERNEL_ATOL or not torch.isfinite(out).all()):
            raise SystemExit(f"flash_attention disagrees with its plain version on {name}")
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: flash_attention(q, k, v, mask))
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, mask), reps=10)
        qt, kt, vt, mt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask[:, None]
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mt, enable_gqa=True))
        moved = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size() + mask.numel()
        flops = 4 * b_ * h * t_ * s_ * d
        bytes_ms, ops_ms = moved / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
        times[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bytes_ms=bytes_ms, ops_ms=ops_ms)
        log(f"# flash_attention {name} timing (B={b_}, T=S={t_}, max_abs_err {err:.3e}): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({moved / 1e6:.1f} MB -> {bytes_ms:.4f} ms, {flops / 1e9:.1f} GFLOP -> {ops_ms:.4f} ms), "
            f"{flops / ms / 1e9:.1f} TFLOP/s, kernel / sdpa {ms / library_ms:.3f}")
    flash_attention.launches = 0  # comparison launches do not count
    ms, plain_ms, library_ms, bytes_ms, ops_ms = (times["bridge"][k] for k in
                                                  ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms"))
    return [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "intact_tpu_torch/csrc/flash_attention.cu",
        "replaces": "intact_tpu/ops/pallas_attention.py:71",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "batch1_ms": times["batch1"]["ms"], "batch1_library_ms": times["batch1"]["library_ms"],
        "train_ms": times["train"]["ms"], "train_library_ms": times["train"]["library_ms"],
    }, phase_adam_kernel(), phase_w8a8_kernel()]


def fp8_index(codes: torch.Tensor) -> torch.Tensor:
    """fp8 codes (sign-magnitude bytes) -> integers ordered like their
    values, so that neighbouring codes differ by 1."""
    u = codes.view(torch.uint8).to(torch.int32)
    return torch.where(u >= 128, -(u - 128), u)


def adam_case(rng: np.random.Generator, L: int, r: int, NB: int, B: int, fp8: bool, p_dtype=torch.bfloat16):
    """Random p and g (bf16 or fp32) and moments at realistic magnitudes."""
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 31)))

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda").mul_(std)

    p = randn(L, r, B, std=0.02).to(p_dtype)
    g = randn(r, B, std=1e-3).to(p_dtype)
    mu, nu = randn(L, NB, B, std=1e-3), randn(L, NB, B, std=1e-6).square_()
    if not fp8:
        return p, g, mu, torch.zeros(L, NB, device="cuda"), nu, torch.zeros(L, NB, device="cuda")
    out = []
    for x, dt in ((mu, torch.float8_e4m3fn), (nu, torch.float8_e5m2)):
        s = x.abs().amax(-1) / (448.0 if dt == torch.float8_e4m3fn else 57344.0)
        out += [(x / s[..., None]).to(dt), s]
        del x
    return (p, g, *out)


def adam_bytes(r: int, B: int, p_dtype, fp8: bool) -> int:
    """Bytes one call must move: p read and written, g read, the two moment
    rows read and written, and with fp8 the two scale rows read and written."""
    p = torch.finfo(p_dtype).bits // 8
    m = 1 if fp8 else 4
    return r * B * (3 * p + 4 * m) + (r * 4 * 4 if fp8 else 0)


def adam_check_case(name: str, orig, kw: dict, calls: int = 1) -> float:
    """fused_adam_rows against its plain version on copies of orig; with
    calls > 1 the kernel runs that many times back to back on its cached
    workspace and the plain version's last call starts from the kernel's
    state (ss accumulates every call on both sides). -> max |p difference|."""
    from intact_tpu_torch.ops.fused_adam import fused_adam_rows, fused_adam_rows_reference

    layer, off = kw["layer"], kw["row_offset"]
    L, r, B = orig[0].shape
    kern = [x.clone() for x in orig]
    ref = [x.clone() for x in orig]
    ss_k, ss_r = torch.zeros(1, device="cuda"), torch.zeros(1, device="cuda")
    for c in range(calls):
        if c == calls - 1:
            ref = [x.clone() for x in kern]
        fused_adam_rows(*kern, ss=ss_k, **kw)
        torch.cuda.synchronize()
        fused_adam_rows_reference(*ref, ss=ss_r, **kw)
    rows = slice(off, off + r)
    fp8 = kern[2].dtype != torch.float32
    pk, pr = kern[0][layer].float(), ref[0][layer].float()
    mant = 7 if kern[0].dtype == torch.bfloat16 else 23
    ulp = torch.exp2(torch.floor(torch.log2(pr.abs().clamp_min(2.0**-126))) - mant)
    p_ulps = ((pk - pr).abs() / ulp).max().item()
    if fp8:
        code_gap = max((fp8_index(kern[i][layer, rows]) - fp8_index(ref[i][layer, rows])).abs().max().item()
                       for i in (2, 4))
        scale_rel = max(((kern[i][layer, rows] - ref[i][layer, rows]).abs() / ref[i][layer, rows]).max().item()
                        for i in (3, 5))
    else:
        code_gap = 0
        scale_rel = max(((kern[i][layer, rows] - ref[i][layer, rows]).abs()
                         / ref[i][layer, rows].abs().clamp_min(1e-30)).max().item() for i in (2, 4))
    ss_rel = abs(ss_k.item() - ss_r.item()) / ss_r.item()
    untouched = all(
        torch.equal(k[:layer], o[:layer]) and torch.equal(k[layer + 1:], o[layer + 1:])
        for k, o in zip(kern, orig)
    ) and all(
        torch.equal(kern[i][layer, :off], orig[i][layer, :off])
        and torch.equal(kern[i][layer, off + r:], orig[i][layer, off + r:]) for i in (2, 3, 4, 5))
    same_p = torch.equal(kern[0], ref[0])
    log(f"# fused_adam_rows {name}: p [{L}, {r}, {B}] {kern[0].dtype}, moments {list(kern[2].shape)} "
        f"{kern[2].dtype}/{kern[4].dtype}, layer {layer}, rows [{off}, {off + r}), SR {kw['stochastic']}, "
        f"{calls} call(s): p max {p_ulps:.3f} ulp (gate: bit-equal {same_p}), codes max {code_gap} apart (tol 1), "
        f"{'scales' if fp8 else 'fp32 moments'} max rel {scale_rel:.3e} (tol {ADAM_SCALE_RTOL}), "
        f"ss rel {ss_rel:.3e} (tol {ADAM_SS_RTOL}), outside rows/layers bit-identical {untouched}")
    if not (same_p and code_gap <= 1 and scale_rel <= ADAM_SCALE_RTOL and ss_rel <= ADAM_SS_RTOL
            and untouched and all(torch.isfinite(x.float()).all() for x in kern)):
        raise SystemExit(f"fused_adam_rows disagrees with its plain version on {name}")
    return (pk - pr).abs().max().item()


def adam_math_checks() -> None:
    """The kernel's fast division, square root and direction against the
    correctly rounded operations, bit for bit, wherever it takes them."""
    from intact_tpu_torch.ops.fused_adam import math_check

    gen = torch.Generator(device="cuda").manual_seed(4)
    n = 1 << 24

    def exp2(lo, hi):
        return torch.exp2(torch.randint(lo, hi, (n,), generator=gen, device="cuda").float())

    def with_zeros(x):  # a tenth of the values +0 or -0, as moments that never had a gradient
        zero = torch.rand(n, generator=gen, device="cuda") < 0.1
        return torch.where(zero, torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 0.0, -0.0), x)

    a = (torch.rand(n, generator=gen, device="cuda") * 2 - 1) * exp2(-61, 62)
    d = (torch.rand(n, generator=gen, device="cuda") + 1) * exp2(-61, 62)
    results = {"divide": math_check(with_zeros(a), d, "divide"), "sqrt": math_check(a.abs(), d, "sqrt")}
    for c1, c2 in ((1 - 0.9, 1 - 0.999), (1 - 0.9**3, 1 - 0.999**3), (1.0, 1.0)):
        for scale in (1e-3, 1e-9):
            m = with_zeros(torch.randn(n, generator=gen, device="cuda") * scale)
            v = with_zeros(torch.randn(n, generator=gen, device="cuda").square() * scale**2 + torch.rand(
                n, generator=gen, device="cuda") * scale)
            results[f"direction c1 {c1:.3g} c2 {c2:.3g} |mu| ~{scale:g}"] = math_check(m, v, "direction", c1, c2, 1e-8)
    log("# fused_adam_rows fast paths vs correctly rounded (cases in range, differing): "
        + ", ".join(f"{k} {t}/{w}" for k, (t, w) in results.items()))
    if any(w for _, w in results.values()) or any(t < n // 2 for t, _ in results.values()):
        raise SystemExit("the row kernel's fast division or square root differs from the correctly rounded one")


def phase_adam_kernel() -> dict:
    """fused_adam_rows against its plain version on the card: the Gemma-2B
    gate leaf in the full packed fp8 moments (SR on and off), an fp32 moment
    case, fp32 p and g (the fp32-master case) and two calls back to back;
    every row and layer outside the leaf's must stay as it was. Then the
    fast-path checks, the SASS instructions per element, and the gate leaf's
    times beside its bound (bf16 and fp32 p)."""
    from intact_tpu_torch.ops import build
    from intact_tpu_torch.ops.fused_adam import fused_adam_rows, fused_adam_rows_reference
    from intact_tpu_torch.train.optim import OptimizerConfig

    hp = OptimizerConfig(lr=5e-5, weight_decay=0.0)
    rng = np.random.default_rng(3)
    # Gemma-2B trunk pack at block 2048: NB = 57344 rows per layer, the gate
    # leaf owns rows [20992, 20992 + 16384) (TrunkPack order: attn k, o, q, v,
    # mlp down, gate, up, then the norms)
    gate = dict(L=18, r=16384, NB=57344, B=2048, off=20992, layer=5)
    expert_q = dict(L=4, r=1024, NB=4096, B=2048, off=1024, layer=2)
    cases = {
        "gate_fp8_sr": (gate, True, True, torch.bfloat16, 1),
        "gate_fp8": (gate, True, False, torch.bfloat16, 1),
        "expert_q_fp32_sr": (expert_q, False, True, torch.bfloat16, 1),
        "expert_q_fp32_params": (expert_q, True, False, torch.float32, 1),
        "expert_q_two_calls": (expert_q, True, True, torch.bfloat16, 2),
    }
    hyp = torch.tensor([1 - 0.9**3, 1 - 0.999**3, 5e-5, 0.7], device="cuda")
    max_err = 0.0
    timed = None
    for name, (sh, fp8, sr, p_dtype, calls) in cases.items():
        L, r, NB, B, off, layer = (sh[k] for k in ("L", "r", "NB", "B", "off", "layer"))
        orig = adam_case(rng, L, r, NB, B, fp8, p_dtype)
        kw = dict(layer=layer, row_offset=off, hyp=hyp, hp=hp, salt=987654321, stochastic=sr)
        max_err = max(max_err, adam_check_case(name, orig, kw, calls))
        if name == "gate_fp8_sr":
            timed = [x.clone() for x in orig], kw
        del orig
        torch.cuda.empty_cache()
    adam_math_checks()

    so = build._target("fused_adam_rows")
    clock_hz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                    check=True, capture_output=True, text=True, timeout=60).stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sass = {}
    for label, symbol in (("bf16 p, fp8, SR", "fused_adam_rows_kernelILb0ELb1ELb1E"),
                          ("fp32 p, fp8", "fused_adam_rows_kernelILb1ELb1ELb0E")):
        n_ins, ops = sass_fast_path(so, symbol)
        sass[label] = n_ins / ADAM_ELEMS_PER_THREAD
        top = ", ".join(f"{k} {v}" for k, v in sorted(ops.items(), key=lambda x: -x[1])[:10])
        log(f"# fused_adam_rows SASS ({label}): {n_ins} instructions per thread per row on the in-range path, "
            f"{sass[label]:.2f} per element ({top})")

    args, kw = timed
    L, r, B = args[0].shape
    ss = torch.zeros(1, device="cuda")
    call = lambda: fused_adam_rows(*args, ss=ss, **kw)  # noqa: E731
    ms = cuda_ms(call)
    dev_ms = device_ms(call, kernel="fused_adam_rows_kernel")
    plain_ms = cuda_ms(lambda: fused_adam_rows_reference(*args, ss=ss, **kw), reps=5, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        call()
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    n = r * B
    moved = adam_bytes(r, B, torch.bfloat16, True)
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = n * ADAM_FLOPS_PER_ELEM / H100_FP32_FLOPS * 1e3
    issue_ms = n / 32 * sass["bf16 p, fp8, SR"] / (sms * 4 * clock_hz) * 1e3
    log(f"# fused_adam_rows gate leaf timing: kernel {ms:.4f} ms (CUDA events around the wrapper), device "
        f"{dev_ms:.4f} ms (profiler), plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({moved / 1e6:.1f} MB -> {bytes_ms:.4f} ms, {n * ADAM_FLOPS_PER_ELEM / 1e9:.2f} GFLOP fp32 -> "
        f"{ops_ms:.4f} ms), {moved / dev_ms / 1e6:.1f} GB/s on the device, device / bound "
        f"{dev_ms / bytes_ms:.3f}; issue time of its SASS at {clock_hz / 1e9:.3f} GHz on {sms} SMs "
        f"{issue_ms:.4f} ms; wrapper host time {host_us:.1f} us per call; no library call computes this function")
    del args, timed
    torch.cuda.empty_cache()
    # what this card's memory sustains for a plain read-and-write stream of
    # the gate leaf's size: one device-to-device copy of 336 MB
    src = torch.empty(moved // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = device_ms(lambda: dst.copy_(src))
    log(f"# a device copy of {src.numel() / 1e6:.1f} MB (reads and writes {2 * src.numel() / 1e6:.1f} MB): device "
        f"{copy_ms:.4f} ms, {2 * src.numel() / copy_ms / 1e9:.3f} TB/s; the row kernel moves "
        f"{moved / dev_ms / 1e9:.3f} TB/s, {copy_ms * moved / (2 * src.numel()) / dev_ms:.3f} of the copy's rate")
    del src, dst
    # the fp32-master case at the gate leaf's shape (one layer)
    args32 = adam_case(rng, 1, 16384, 16384, 2048, True, torch.float32)
    kw32 = dict(kw, layer=0, row_offset=0, stochastic=False)
    ms32 = cuda_ms(lambda: fused_adam_rows(*args32, ss=ss, **kw32))
    dev32 = device_ms(lambda: fused_adam_rows(*args32, ss=ss, **kw32), kernel="fused_adam_rows_kernel")
    bound32 = adam_bytes(16384, 2048, torch.float32, True) / H100_BYTES_PER_S * 1e3
    log(f"# fused_adam_rows gate leaf with fp32 p and g: kernel {ms32:.4f} ms, device {dev32:.4f} ms, "
        f"bound {bound32:.4f} ms (bytes), device / bound {dev32 / bound32:.3f}")
    del args32
    torch.cuda.empty_cache()
    fused_adam_rows.launches = 0  # comparison launches do not count
    return {
        "name": "fused_adam_rows",
        "route": "cuda",
        "source": "intact_tpu_torch/csrc/fused_adam_rows.cu",
        "replaces": "intact_tpu/ops/pallas_adam.py:141",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        # fp8 moments with per-row absmax scales and hash SR: no single
        # PyTorch call computes this update
        "library_ms": None,
        "device_ms": dev_ms,
        "host_us_per_call": host_us,
        "sass_per_element": sass["bf16 p, fp8, SR"],
        "issue_ms": issue_ms,
        "fp32_params_ms": ms32,
        "fp32_params_device_ms": dev32,
        "fp32_params_bound_ms": bound32,
        "copy_rate_tb_s": moved / copy_ms / 1e9,
        "shape": "Gemma-2B gate leaf, 16384 x 2048, fp8 moments, SR",
    }


H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
# w8a8_matmul against its plain version: the same codes and scales are
# expected; each fused multiply-add of the plain version is formed in float64,
# which rounds twice where the kernel's __fmaf_rn rounds once, so an output
# may differ by one fp32 ulp where that lands on an fp32 tie (about 2^-29 of
# values), which a bf16 cast hides unless it also sits on a bf16 tie: allow
# one bf16 ulp of the row's largest |y| per element
W8A8_ROW_RTOL = 2.0**-8
# the bridge's W8A8 products: (name, M, K, N); M = B*256 (SigLIP, img_proj),
# B*328 (Gemma prefill), B*5 (expert decode) at batch 64, and a batch-1 decode
W8A8_SHAPES = (
    ("gemma_q", 20992, 2048, 2048), ("gemma_k", 20992, 2048, 256), ("gemma_up", 20992, 2048, 16384),
    ("gemma_down", 20992, 16384, 2048), ("siglip_fc1", 16384, 1152, 4304), ("siglip_fc2", 16384, 4304, 1152),
    ("img_proj", 16384, 1152, 2048), ("expert_q", 320, 1024, 2048), ("expert_down", 320, 4096, 1024),
    ("expert_q_b1", 5, 1024, 2048), ("expert_down_b1", 5, 4096, 1024),
)
W8A8_TIMED = "gemma_up"  # the shape of the kernels line


def w8a8_case(gen: torch.Generator, m: int, k: int, n: int):
    """bf16 activations at unit scale with a few large channels, int8 weight
    codes over the full range, K-major ([N, K], as the serving tree holds
    them), per-channel scales near 1e-3, a bias."""
    x = torch.randn(m, k, generator=gen, device="cuda")
    x[:, ::97] *= 8.0  # outlier channels, as real activations have
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    ws = (torch.rand(n, generator=gen, device="cuda") + 0.5) * 1e-3
    bias = torch.randn(n, generator=gen, device="cuda") * 0.1
    return x.to(torch.bfloat16), wq, ws, bias


def w8a8_bound_ms(m: int, k: int, n: int) -> tuple[float, float, str]:
    """(bound ms, bytes ms, what bounds it): x bf16 read once, w int8 and its
    fp32 scales read once, y bf16 written once; 2*M*K*N int8 operations."""
    moved = m * k * 2 + k * n + n * 4 + m * n * 2
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = 2 * m * k * n / H100_INT8_OPS * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, "bytes" if bytes_ms >= ops_ms else "operations"


def phase_w8a8_kernel() -> dict:
    """w8a8_matmul against its plain version on the card at the bridge's
    shapes with K-major codes (the serving tree's), per row and (at K 16384
    and 4304, and the expert's K 4096) per 2048-chunk, and two ragged cases
    (one with [K, N] codes): the wrapper's outputs, and the kernel's codes and
    scales; then times at each per-row shape beside the bound, the plain
    version, torch._int_mm on the same codes (the product only) and the bf16
    matmul that int8 replaces, with the kernel's effective rates."""
    from intact_tpu_torch.ops import w8a8

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = [(name, m, k, n, None) for name, m, k, n in W8A8_SHAPES]
    cases += [(name + "_chunk2048", m, k, n, w8a8.PALLAS_BLOCK_K)
              for name, m, k, n in W8A8_SHAPES if k in (16384, 4304) or name == "expert_down"]
    cases += [("ragged_fp32", 77, 300, 131, None), ("ragged_chunk128", 45, 1000, 200, 128)]
    max_err, rows, timed = 0.0, [], None
    for name, m, k, n, chunk in cases:
        x, wk, ws, bias = w8a8_case(gen, m, k, n)
        layout, w_in = "nk", wk
        if name.startswith("ragged_fp32"):
            x, out_dtype = x.float(), torch.float32
            layout, w_in = "kn", wk.t().contiguous()  # the [K, N] form
        else:
            out_dtype = torch.bfloat16
        n0 = w8a8.w8a8_matmul.launches
        y = w8a8.w8a8_matmul(x, w_in, ws, bias, chunk, out_dtype, layout)  # the wrapper the main path calls
        if w8a8.w8a8_matmul.launches != n0 + 1:
            raise SystemExit(f"w8a8_matmul did not launch its kernel on {name}")
        _, xq, xs = w8a8.launch(x, w_in, ws, bias, chunk, out_dtype, layout)  # for its codes and scales
        torch.cuda.synchronize()
        rq, rs = w8a8.quantize_reference(x, chunk)
        ref = w8a8.w8a8_matmul_reference(x, wk.t(), ws, bias, chunk, out_dtype)
        same_codes = torch.equal(xq[:, :k], rq) and not xq[:, k:].any().item()
        same_scales = torch.equal(xs, rs)
        diff = (y.float() - ref.float()).abs()
        err = diff.max().item()
        row_tol = W8A8_ROW_RTOL * ref.float().abs().amax(dim=1, keepdim=True)
        unequal = int((y != ref).sum().item())
        ok = same_codes and same_scales and bool((diff <= row_tol).all()) and bool(torch.isfinite(y).all())
        log(f"# w8a8_matmul {name}: M {m} K {k} N {n} chunk {chunk or 'row'} {x.dtype}->{out_dtype} {layout} "
            f"{w8a8.plan(m, n, k, chunk)}: codes equal "
            f"{same_codes}, scales equal {same_scales}, outputs unequal {unequal} of {y.numel()}, max abs err "
            f"{err:.3e} (tol {W8A8_ROW_RTOL:.4g} x row max |y|), max |y| {ref.float().abs().max().item():.3e}")
        if not ok:
            raise SystemExit(f"w8a8_matmul disagrees with its plain version on {name}")
        max_err = max(max_err, err)
        if chunk is None and not name.startswith("ragged"):
            rows.append((name, m, k, n, x, wk, ws, bias, xq))
        del y, ref, rq, rs
    for name, m, k, n, x, wk, ws, bias, xq in rows:
        ms = cuda_ms(lambda: w8a8.w8a8_matmul(x, wk, ws, bias, out_dtype=torch.bfloat16, weight_layout="nk"))
        plain_ms = cuda_ms(lambda: w8a8.w8a8_matmul_reference(x, wk.t(), ws, bias, out_dtype=torch.bfloat16),
                           reps=3, warmup=1)
        codes = xq[:, :k].contiguous()
        try:
            int_mm_ms = cuda_ms(lambda: torch._int_mm(codes, wk.t()))
        except RuntimeError as e:  # _int_mm takes M > 16 only
            int_mm_ms = None
            log(f"#   torch._int_mm refused {name}: {str(e).splitlines()[0][:100]}")
        wb = wk.t().to(torch.bfloat16)
        bf16_ms = cuda_ms(lambda: torch.matmul(x, wb))
        dev_ms = device_ms(lambda: w8a8.w8a8_matmul(x, wk, ws, bias, out_dtype=torch.bfloat16, weight_layout="nk"))
        bf16_dev_ms = device_ms(lambda: torch.matmul(x, wb))
        bound, bytes_ms, by = w8a8_bound_ms(m, k, n)
        moved = m * k * 2 + k * n + n * 4 + m * n * 2
        log(f"# w8a8_matmul timing {name} (M {m} K {k} N {n}, {w8a8.plan(m, n, k).mode}): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, torch._int_mm on the same codes (product only) "
            f"{'n/a' if int_mm_ms is None else f'{int_mm_ms:.4f} ms'}, bf16 torch.matmul {bf16_ms:.4f} ms "
            f"(kernel / bf16 {ms / bf16_ms:.3f}), bound {bound:.4f} ms by {by} ({2 * m * k * n / 1e12:.3f} T int8 "
            f"ops, bytes {bytes_ms:.4f} ms); kernel {2 * m * k * n / ms / 1e9:.1f} TOPS, {moved / ms / 1e6:.1f} GB/s; "
            f"device time per call (profiler, no host gaps): kernel {dev_ms:.4f} ms, bf16 {bf16_dev_ms:.4f} ms")
        if name == W8A8_TIMED:
            timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, int_mm_ms=int_mm_ms, bf16_ms=bf16_ms,
                         device_ms=dev_ms)
        del wb
    rows.clear()
    torch.cuda.empty_cache()
    w8a8.w8a8_matmul.launches = 0  # comparison launches do not count
    return {
        "name": "w8a8_matmul",
        "route": "cuda",
        "source": "intact_tpu_torch/csrc/w8a8_matmul.cu",
        "replaces": "intact_tpu/ops/pallas_int8.py:81",
        "launches": None,
        "max_abs_err": max_err,
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"],
        # no single PyTorch call quantizes the activations, multiplies in int8
        # and rescales; the product alone and the bf16 product it replaces:
        "library_ms": None,
        "int_mm_product_only_ms": timed["int_mm_ms"],
        "bf16_matmul_ms": timed["bf16_ms"],
        "device_ms": timed["device_ms"],
        "shape": "Gemma-2B up projection, M 20992 K 2048 N 16384 (batch-64 prefill)",
    }


# ---------------------------------------------------------------------------
# 3. full-width serving
# ---------------------------------------------------------------------------

def make_obs(rng: np.random.Generator, b: int, size: int) -> dict:
    tasks = ["put the spoon on the towel", "put carrot on plate",
             "stack the green block on the yellow block", "put eggplant into yellow basket"]
    return {
        "image": rng.integers(0, 256, size=(b, size, size, 3), dtype=np.uint8),
        "state": rng.standard_normal((b, 7), dtype=np.float32),
        "task": [tasks[i % len(tasks)] for i in range(b)],
    }


def phase_serving() -> int:
    """-> the kernel's launches on the main path."""
    from intact_tpu_torch.models.common import tree_leaves
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.models.pi0.policy import Pi0Policy
    from intact_tpu_torch.ops.flash_attention import flash_attention

    cfg = Pi0Config.bridge()
    per_inference = cfg.vlm.depth - 1  # kv_only prefill: depth-1 attention layers
    torch.cuda.reset_peak_memory_stats()  # the kernel phase's comparisons are not serving's
    t0 = time.perf_counter()
    policy = Pi0Policy(cfg, seed=0, tokenizer_path="hash", device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(policy.params))
    log(f"# serving: Pi0 bridge, {n_params / 1e9:.3f} B params bf16, init {time.perf_counter() - t0:.3f} s")

    rng = np.random.default_rng(1)
    size = cfg.vision.image_size
    obs1, obs64 = make_obs(rng, 1, size), make_obs(rng, 64, size)

    # --- the main path: a few requests as the server's handler makes them ---
    flash_attention.launches = 0
    inferences = 0

    def request(fn, *args):
        nonlocal inferences
        before = flash_attention.launches
        out = fn(*args)
        grew = flash_attention.launches - before
        if grew not in (0, per_inference):
            raise SystemExit(f"{grew} kernel launches in one request; expected 0 or {per_inference}")
        inferences += grew // per_inference
        return out

    actions = [request(policy.select_action, obs1) for _ in range(5)]  # infers on calls 1 and 5
    policy.reset()  # what the server does on {"reset": True}
    actions.append(request(policy.select_action, obs1))
    chunk64 = request(policy.sample_action_chunk, obs64)
    launches = flash_attention.launches
    # -------------------------------------------------------------------------

    if inferences != 4 or launches != per_inference * inferences:
        raise SystemExit(f"{launches} kernel launches over {inferences} inferences; expected {per_inference} each")
    for a in actions:
        if a.shape != (1, cfg.max_action_dim) or not np.isfinite(a).all():
            raise SystemExit(f"bad batch-1 action {a.shape}")
    if chunk64.shape != (64, cfg.chunk_size, cfg.max_action_dim) or not np.isfinite(chunk64).all():
        raise SystemExit(f"bad batch-64 chunk {chunk64.shape}")
    log(f"# serving: {inferences} inferences, {launches} flash_attention launches "
        f"({per_inference} per inference), actions finite, chunk {chunk64.shape}")

    # kernel path vs plain-attention path: same params, inputs and noise
    inputs = policy.device_inputs(obs64)
    gen = torch.Generator(device="cuda").manual_seed(2)
    noise = pi0.sample_noise(gen, (64, cfg.chunk_size, cfg.max_action_dim), "cuda")
    a_kernel = pi0.sample_actions(policy.params, None, *inputs, cfg, policy.policy, noise=noise)
    a_plain = pi0.sample_actions(policy.params, None, *inputs,
                                 dataclasses.replace(cfg, attention_impl="xla"), policy.policy, noise=noise)
    rel = ((a_kernel - a_plain).norm() / a_plain.norm()).item()
    diff = (a_kernel - a_plain).abs().max().item()
    log(f"# serving: kernel vs plain attention, batch 64 actions: rel L2 {rel:.3e} (rtol {ACTIONS_RTOL}), "
        f"max abs {diff:.3e}, max |a| {a_plain.abs().max().item():.3e}")
    if not rel <= ACTIONS_RTOL:
        raise SystemExit("actions from the kernel path disagree with the plain-attention path")

    for b, obs, reps in ((1, obs1, 5), (64, obs64, 3)):
        policy.sample_action_chunk(obs)  # warm
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            policy.sample_action_chunk(obs)  # ends in a device->host copy
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        log(f"# serving batch {b}: median inference {med * 1e3:.2f} ms over {reps} "
            f"({[round(x * 1e3, 2) for x in times]}), {b * cfg.n_action_steps / med:.2f} policy steps/s")
    log(f"# peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for b, obs in ((1, obs1), (64, obs64)):
        profile_pass(f"batch {b}", lambda: policy.sample_action_chunk(obs))
    return launches


KERNEL_SYMBOLS = ("attn_kernel", "fused_adam_rows_kernel", "quantize_kernel", "gemm_kernel", "finish_kernel")


def profile_pass(label: str, fn, in_order: str | None = None):
    """Device busy share and the kernels that take the most device time in
    one call of fn (which ends in a sync), under torch.profiler (which adds
    host time of its own). -> {kernel name: (device ms, launches)} for the
    kernels of KERNEL_SYMBOLS; with `in_order`, also the device ms of each
    launch of the kernels whose name holds it, in launch order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"# profile {label}: wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in kernels)} kernel launches")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    ours = [e for e in kernels if any(name in e.key for name in KERNEL_SYMBOLS) and e not in top]
    for e in top + ours:
        log(f"#   {e.self_device_time_total / 1e3:8.3f} ms {100 * e.self_device_time_total / busy_us:5.1f}% "
            f"x{e.count:<5d} {e.key[:90]}")
    totals = {}
    for e in kernels:
        for name in KERNEL_SYMBOLS:
            if name in e.key:
                ms, n = totals.get(name, (0.0, 0))
                totals[name] = (ms + e.self_device_time_total / 1e3, n + e.count)
    if in_order is None:
        return totals
    launches = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                       and in_order in e.name), key=lambda e: e.time_range.start)
    return totals, [(e.time_range.end - e.time_range.start) / 1e3 for e in launches]


# ---------------------------------------------------------------------------
# 3b. full-width int8 serving through the server role's wrapper
# ---------------------------------------------------------------------------

EV_CONFIG = "config/experiment/simpler/pi0_finetune_bridge_ev.yaml"
SERVING_SEED = 0  # the bf16 serving phase's weights, quantized


def ev_config(quantize: bool = True):
    """The server role's config (config/experiment/simpler/pi0_finetune_bridge_ev.yaml)
    with int8 on (or off), random weights from the bf16 phase's seed (no
    checkpoint) and the hash tokenizer."""
    from intact_tpu_torch.config import TrainPipelineConfig, apply_overrides, from_dict, load_yaml

    overrides = {"eval_cfg.role": "server", "eval_cfg.quantize_int8": json.dumps(quantize),
                 "eval_cfg.pretrained_model_path": "null", "tokenizer_path": "hash", "seed": str(SERVING_SEED)}
    return from_dict(TrainPipelineConfig, apply_overrides(load_yaml(EV_CONFIG), overrides))


def w8a8_per_inference(cfg) -> int:
    """W8A8 products of one inference: SigLIP 6 per layer, img_proj, the
    kv_only prefill's 7 per full layer and the last layer's k and v, and the
    expert's 7 per layer per Euler step."""
    return cfg.vision.depth * 6 + 1 + (cfg.vlm.depth - 1) * 7 + 2 + cfg.num_steps * cfg.expert.depth * 7


def wire_inputs(rng: np.random.Generator, b: int, size: int) -> list[dict]:
    """b single-row requests as Pi0Session.preprocess emits them: a resized
    uint8 frame, the normalized 7-d proprio, one task string."""
    obs = make_obs(rng, b, size)
    state = np.clip(obs["state"], -1.0, 1.0)
    return [{"image": obs["image"][i:i + 1], "state": state[i:i + 1], "task": [obs["task"][i]]} for i in range(b)]


def phase_int8_serving() -> dict:
    """-> {kernel: launches} on the int8 serving path."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.ops import w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    cfg = ev_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wrapper = make_policy_wrapper(cfg, device=DEVICE)
    torch.cuda.synchronize()
    mc = wrapper.model_cfg
    leaves = cm.tree_leaves(wrapper.policy.params)
    n_int8 = sum(x.numel() for x in leaves if x.dtype == torch.int8)
    n_other = sum(x.numel() for x in leaves if x.dtype != torch.int8)
    per_inference = w8a8_per_inference(mc)
    flash_per = mc.vlm.depth - 1
    log(f"# int8 serving: Pi0PolicyWrapper from {EV_CONFIG} ({cfg.model_type}, quantize_int8 "
        f"{cfg.eval_cfg.quantize_int8}, seed {cfg.seed}), {n_int8 / 1e9:.3f} B int8 weights + "
        f"{n_other / 1e9:.3f} B bf16/fp32 values, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"init {time.perf_counter() - t0:.2f} s (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); "
        f"expect {per_inference} w8a8_matmul and {flash_per} flash_attention launches per inference")

    rng = np.random.default_rng(1)
    size = mc.vision.image_size
    sessions = [wrapper.new_session() for _ in range(64)]
    req1, req64 = wire_inputs(rng, 1, size), wire_inputs(rng, 64, size)

    # --- the main path: fused requests through the wrapper, as the batching server calls it ---
    w8a8.w8a8_matmul.launches = flash_attention.launches = 0
    inferences = 0

    def fused(items):
        nonlocal inferences
        w0, f0 = w8a8.w8a8_matmul.launches, flash_attention.launches
        out = wrapper.infer_batch(items)
        dw, df = w8a8.w8a8_matmul.launches - w0, flash_attention.launches - f0
        if dw != per_inference or df != flash_per:
            raise SystemExit(f"one fused inference launched w8a8_matmul {dw} and flash_attention {df} times; "
                             f"expected {per_inference} and {flash_per}")
        inferences += 1
        return out

    out1 = [fused([(req1[0], sessions[0])]) for _ in range(2)]
    out64 = fused(list(zip(req64, sessions)))
    launches = {"w8a8_matmul": w8a8.w8a8_matmul.launches, "flash_attention": flash_attention.launches}
    # -------------------------------------------------------------------------------------------
    for a in [o[0] for o in out1] + out64:
        if isinstance(a, Exception) or a.shape != (cfg.eval_cfg.action_step, 7) or not np.isfinite(a).all():
            raise SystemExit(f"bad int8 serving result {a!r:.200}")
    log(f"# int8 serving: {inferences} fused inferences (batch 1, 1, 64), launches {launches} "
        f"({per_inference} w8a8_matmul and {flash_per} flash_attention each), 66 env actions of shape "
        f"{out64[0].shape}, finite")

    # kernel path vs plain path on the same int8 params, inputs and noise
    policy = wrapper.policy
    batch = {"image": np.concatenate([r["image"] for r in req64]),
             "state": np.concatenate([r["state"] for r in req64]), "task": [r["task"][0] for r in req64]}
    inputs = policy.device_inputs(batch)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    noise = pi0.sample_noise(gen, (64, mc.chunk_size, mc.max_action_dim), DEVICE)
    n0 = w8a8.w8a8_matmul.launches
    a_kernel = pi0.sample_actions(policy.params, None, *inputs, mc, policy.policy, noise=noise)
    n1 = w8a8.w8a8_matmul.launches
    real = w8a8.w8a8_matmul

    def plain_w8a8(x, wq, wscale, bias=None, k_chunk=None, out_dtype=None, weight_layout="kn"):
        return w8a8.w8a8_matmul_reference(x, wq if weight_layout == "kn" else wq.t(), wscale, bias, k_chunk,
                                          out_dtype)

    w8a8.w8a8_matmul = plain_w8a8  # the plain W8A8 product, for this comparison only
    try:
        a_w8a8_plain = pi0.sample_actions(policy.params, None, *inputs, mc, policy.policy, noise=noise)
        a_plain = pi0.sample_actions(policy.params, None, *inputs, dataclasses.replace(mc, attention_impl="xla"),
                                     policy.policy, noise=noise)
    finally:
        w8a8.w8a8_matmul = real
    if n1 - n0 != per_inference or w8a8.w8a8_matmul.launches != n1:
        raise SystemExit(f"the comparison's kernel run launched w8a8_matmul {n1 - n0} times and its plain runs "
                         f"{w8a8.w8a8_matmul.launches - n1}; expected {per_inference} and 0")
    rel = ((a_kernel - a_plain).norm() / a_plain.norm()).item()
    rel_w = ((a_kernel - a_w8a8_plain).norm() / a_w8a8_plain.norm()).item()
    same = torch.equal(a_kernel, a_w8a8_plain)
    log(f"# int8 serving: kernel path vs plain path (plain W8A8 product and plain attention), batch 64 "
        f"actions: rel L2 {rel:.3e} (rtol {ACTIONS_RTOL}), max abs {(a_kernel - a_plain).abs().max().item():.3e}; "
        f"with only the W8A8 product plain: rel L2 {rel_w:.3e}, bit-equal {same} (gate: bit-equal)")
    # the kernel's codes, scales and outputs equal the plain version's at every
    # bridge shape (phase 2), so swapping only the W8A8 product must leave the
    # actions bit for bit; a tolerance would pass a kernel that skipped the
    # quantization (int8 vs bf16 moves the actions by ~4e-2)
    if not same:
        raise SystemExit("int8 actions with the W8A8 kernel differ from those with its plain version")
    if not rel <= ACTIONS_RTOL:
        raise SystemExit("int8 actions from the kernel path disagree with the plain path")
    del a_plain, a_w8a8_plain
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    items1, items64 = [(req1[0], sessions[0])], list(zip(req64, sessions))
    for items in (items1, items64):
        wrapper.infer_batch(items)
    log(f"# int8 serving peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(one wrapper, batch 1 and 64)")

    # the same server role with quantize_int8 off: the same random weights in
    # bf16 behind the same wrapper, so both latencies include the fuse, the
    # uint8 upload and the adapters' postprocess
    bf16_wrapper = make_policy_wrapper(ev_config(quantize=False), device=DEVICE)
    bf16_sessions = [bf16_wrapper.new_session() for _ in range(64)]
    a_bf16 = pi0.sample_actions(bf16_wrapper.policy.params, None, *inputs, mc, bf16_wrapper.policy.policy,
                                noise=noise)
    mse = (a_kernel - a_bf16).square().mean().item()
    log(f"# int8 vs bf16 actions (same random weights, inputs and noise, batch 64): MSE {mse:.4e}, "
        f"rel L2 {((a_kernel - a_bf16).norm() / a_bf16.norm()).item():.3e}, mean |a_bf16|^2 "
        f"{a_bf16.square().mean().item():.4e} (no gate on random weights)")
    del a_bf16, inputs
    torch.cuda.empty_cache()

    # latency through infer_batch, int8 and bf16 wrappers alternating call by call
    runs = {"int8": (wrapper, sessions), "bf16": (bf16_wrapper, bf16_sessions)}
    for b, reps in ((1, 5), (64, 3)):
        times = {k: [] for k in runs}
        calls = {k: [(req, ss[i]) for i, req in enumerate(req1 if b == 1 else req64)] for k, (w, ss) in runs.items()}
        for k, (w, _) in runs.items():
            w.infer_batch(calls[k])  # warm
        for _ in range(reps):
            for k, (w, _) in runs.items():
                t0 = time.perf_counter()
                w.infer_batch(calls[k])  # ends in a device->host copy and the adapters' postprocess
                times[k].append(time.perf_counter() - t0)
        med = {k: statistics.median(v) for k, v in times.items()}
        for k in runs:
            log(f"# {k} serving batch {b} (Pi0PolicyWrapper.infer_batch): median fused inference "
                f"{med[k] * 1e3:.2f} ms over {reps} ({[round(x * 1e3, 2) for x in times[k]]}), "
                f"{b * mc.n_action_steps / med[k]:.2f} policy steps/s")
        log(f"# serving batch {b} through the wrapper: int8 / bf16 latency {med['int8'] / med['bf16']:.3f}")
    for b in (1, 64):
        for k, (w, ss) in runs.items():
            calls = [(req, ss[i]) for i, req in enumerate(req1 if b == 1 else req64)]
            profile_pass(f"{k} wrapper batch {b}", lambda: w.infer_batch(calls))
    del wrapper, policy, bf16_wrapper, runs
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 4. full-width training
# ---------------------------------------------------------------------------

RECIPE = "config/train/pi0_finetune_bridge_1chip.yaml"
TRAIN_STEPS = 4
# kernel path vs plain path, one step at full width and 4 layers: the two
# round the attention (bf16 P, fp32 sums in another order) at different
# places, which moves the loss and the gradients by ~1e-3 relative; the
# updated parameters differ only where stochastic rounding lands on the other
# side (same salt, nearly the same exact value); a moment code may move by one
# where the gradient moved
TRAIN_LOSS_RTOL = 2e-2
TRAIN_GNORM_RTOL = 5e-2
TRAIN_PARAMS_RTOL = 1e-3  # relative L2 of the parameters after the step
TRAIN_UPDATE_RTOL = 0.5  # relative L2 of the parameter change (mostly +-1 bf16 ulp flips)
TRAIN_CODES_SHARE = 0.05  # share of moment codes more than one code apart


def recipe_config():
    """The 1-chip recipe (config/train/pi0_finetune_bridge_1chip.yaml) with
    the hash tokenizer and a few logged steps."""
    from intact_tpu_torch.config import TrainPipelineConfig, apply_overrides, from_dict, load_yaml

    overrides = {"n_updates": str(TRAIN_STEPS), "log_freq": "1", "tokenizer_path": "hash"}
    return from_dict(TrainPipelineConfig, apply_overrides(load_yaml(RECIPE), overrides))


def expected_row_updates(state, block: int = 2048) -> list[int]:
    """The sizes of the leaves one step updates through fused_adam_rows, one
    entry per launch: every kernel-eligible trunk leaf in every layer, and
    every eligible 8-bit leaf of the head and the embed side."""
    from intact_tpu_torch.ops.fused_adam import eligible
    from intact_tpu_torch.train.fused_joint import EMBED_NAMES, TrunkPack, _is_quant_leaf, tree_items

    sizes = []
    for t in ("vlm", "expert"):
        blocks = state.params[t]["blocks"]
        depth = next(tree_items(blocks))[1].shape[0]
        sizes += depth * [size for size in TrunkPack(blocks, block).sizes if eligible(size, block)]
    for name in EMBED_NAMES + ("action_out_proj",):
        moments = dict(tree_items(state.mu[name], quant_leaves=True))
        sizes += [p.numel() for path, p in tree_items(state.params[name])
                  if _is_quant_leaf(moments[path]) and eligible(p.numel(), block)]
    return sizes


def time_row_update_shapes(sizes: list[int], block: int = 2048) -> float:
    """Each distinct leaf shape of the step (rows of `block`, bf16 p with SR,
    fp8 moments) timed alone: CUDA events around the wrapper and device time
    per call, beside its byte bound; then the step's sum of device time over
    its launches against the bound of all of them. -> that sum, ms. A step
    touches each leaf once, so the calls cycle through copies of the
    arguments, 500 MB in all (ten times the 50 MB L2; 200 MB still left
    the 42 MB leaves partly in L2), and no call finds its bytes there."""
    import itertools
    from collections import Counter

    from intact_tpu_torch.ops.fused_adam import fused_adam_rows
    from intact_tpu_torch.train.optim import OptimizerConfig

    hp = OptimizerConfig(lr=5e-5, weight_decay=0.0)
    hyp = torch.tensor([1 - 0.9**3, 1 - 0.999**3, 5e-5, 0.7], device="cuda")
    ss = torch.zeros(1, device="cuda")
    rng = np.random.default_rng(9)
    step_ms = step_bound = 0.0
    for r, count in sorted(Counter(n // block for n in sizes).items()):
        moved = adam_bytes(r, block, torch.bfloat16, True)
        copies = [adam_case(rng, 1, r, r, block, True) for _ in range(-(-500_000_000 // moved))]
        kw = dict(layer=0, row_offset=0, hyp=hyp, hp=hp, salt=5, stochastic=True)
        cycle = itertools.cycle(copies)
        call = lambda: fused_adam_rows(*next(cycle), ss=ss, **kw)  # noqa: E731
        ms, dev = cuda_ms(call, reps=30), device_ms(call, reps=30, kernel="fused_adam_rows_kernel")
        bound = moved / H100_BYTES_PER_S * 1e3
        step_ms += dev * count
        step_bound += bound * count
        log(f"# fused_adam_rows leaf shape {r} x {block} (x{count} per step): kernel {ms:.4f} ms, device "
            f"{dev:.4f} ms, bound {bound:.4f} ms, device / bound {dev / bound:.3f} ({len(copies)} argument sets)")
        del copies, cycle
    log(f"# fused_adam_rows per training step: {len(sizes)} launches, device time {step_ms:.3f} ms (sum over the "
        f"shapes above) against a bound of {step_bound:.3f} ms ({step_ms / step_bound:.3f}x)")
    torch.cuda.empty_cache()
    return step_ms


def phase_training() -> dict:
    """-> {kernel: launches} on the training path."""
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.ops.fused_adam import fused_adam_rows
    from intact_tpu_torch.train import fused_joint as fj
    from intact_tpu_torch.train.fused_joint import tree_items
    from intact_tpu_torch.train.trainer import Trainer

    cfg = recipe_config()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    torch.cuda.synchronize()
    mc = trainer.model_cfg
    n_params = sum(x.numel() for _, x in tree_items(trainer.state.params))
    sizes = expected_row_updates(trainer.state)
    want_adam, adam_elems = len(sizes), sum(sizes)
    want_flash = 2 * (mc.vlm.depth - 1)
    log(f"# training: Pi0 bridge ({mc.vlm.depth}+{mc.expert.depth} trunk layers, SigLIP {mc.vision.depth}), "
        f"{n_params / 1e9:.3f} B params bf16, batch {trainer.micro_batch_size}, init "
        f"{time.perf_counter() - t0:.2f} s; per step expect {want_adam} fused_adam_rows launches over "
        f"{adam_elems / 1e9:.3f} G elements (bound {adam_elems * ADAM_BYTES_PER_ELEM / H100_BYTES_PER_S * 1e3:.3f} ms) "
        f"and {want_flash} flash_attention launches")

    # record each step the trainer takes: its launches, metrics and time
    steps = []
    real_step = trainer.train_step

    def recorded(state, batch):
        f0, a0 = flash_attention.launches, fused_adam_rows.launches
        t = time.perf_counter()
        out = real_step(state, batch)
        torch.cuda.synchronize()
        steps.append((flash_attention.launches - f0, fused_adam_rows.launches - a0,
                      out[1]["l2_loss"].item(), out[1]["grad_norm"].item(), time.perf_counter() - t))
        return out

    trainer.train_step = recorded
    torch.cuda.reset_peak_memory_stats()
    # --- the main path: the trainer's loop, as `python -m intact_tpu_torch.run` drives it ---
    flash_attention.launches = fused_adam_rows.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches, "fused_adam_rows": fused_adam_rows.launches}
    # -------------------------------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    for i, (nf, na, loss, gnorm, dt) in enumerate(steps):
        log(f"# training step {i + 1}: loss {loss:.6f}, grad_norm {gnorm:.6f}, {dt * 1e3:.2f} ms, "
            f"launches flash_attention {nf}, fused_adam_rows {na}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)) or nf != want_flash or na != want_adam:
            raise SystemExit(f"training step {i + 1}: non-finite metrics or unexpected kernel launches")
    if len(steps) != TRAIN_STEPS or launches["fused_adam_rows"] != TRAIN_STEPS * want_adam:
        raise SystemExit(f"{len(steps)} steps, launches {launches}")
    med = statistics.median(dt for *_, dt in steps[1:])
    log(f"# training: median step {med * 1e3:.2f} ms over steps 2..{TRAIN_STEPS} "
        f"({[round(s[-1] * 1e3, 2) for s in steps]}), {trainer.micro_batch_size / med:.2f} samples/s; "
        f"loop wall {wall:.2f} s for {TRAIN_STEPS} steps incl. data; peak device memory {peak / 2**30:.2f} GiB")
    batch = trainer.device_batch(next(iter(trainer.train_data)))
    rows = []  # the leaf row count of each row-update launch of the profiled step, in order
    real_update = fj.fused_adam_rows

    def recording(p, *args, **kw):
        rows.append(p.shape[1])
        return real_update(p, *args, **kw)

    fj.fused_adam_rows = recording
    try:
        totals, per_launch = profile_pass("training step", lambda: (real_step(trainer.state, batch),
                                                                    torch.cuda.synchronize()),
                                          in_order="fused_adam_rows_kernel")
    finally:
        fj.fused_adam_rows = real_update
    adam_ms, adam_n = totals.get("fused_adam_rows_kernel", (0.0, 0))
    log(f"# training profile: fused_adam_rows_kernel {adam_ms:.3f} ms of device time over {adam_n} launches in one "
        f"step, bound {adam_elems * ADAM_BYTES_PER_ELEM / H100_BYTES_PER_S * 1e3:.3f} ms")
    if len(rows) == len(per_launch):
        by_rows = {}
        for i, (r, ms) in enumerate(zip(rows, per_launch)):
            by_rows.setdefault(r, []).append((ms, i))
        for r, entries in sorted(by_rows.items()):
            times = [ms for ms, _ in entries]
            bound = adam_bytes(r, 2048, torch.bfloat16, True) / H100_BYTES_PER_S * 1e3
            slow = ", ".join(f"#{i} {ms:.4f}" for ms, i in sorted(entries, reverse=True)[:4])
            log(f"#   in the step, leaf shape {r} x 2048: x{len(times)}, {sum(times):.3f} ms, median "
                f"{statistics.median(times):.4f} ms per launch (min {min(times):.4f}; slowest, by launch index "
                f"in the step: {slow}), bound {bound:.4f} ms")
    else:
        log(f"#   {len(rows)} row-update calls against {len(per_launch)} profiled launches: no per-shape split")
    del trainer, batch
    torch.cuda.empty_cache()
    time_row_update_shapes(sizes)
    compare_training_paths()
    train_fp32_masters(want_adam)
    return launches


def train_fp32_masters(want_adam: int, steps: int = 2) -> None:
    """The 1-chip recipe with master_dtype float32 (fp32 trainable
    parameters, no stochastic rounding; the frozen embedding in bf16) through
    the Trainer for a few steps: finite loss and grad norm, and the row
    kernel launched for every eligible leaf, now on fp32 p and g."""
    from intact_tpu_torch.config import TrainPipelineConfig, apply_overrides, from_dict, load_yaml
    from intact_tpu_torch.ops.fused_adam import fused_adam_rows
    from intact_tpu_torch.train.fused_joint import tree_items
    from intact_tpu_torch.train.trainer import Trainer

    overrides = {"n_updates": str(steps), "log_freq": "1", "tokenizer_path": "hash", "master_dtype": "float32"}
    cfg = from_dict(TrainPipelineConfig, apply_overrides(load_yaml(RECIPE), overrides))
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, device=DEVICE)
    dtypes = {str(x.dtype) for path, x in tree_items(trainer.state.params["vlm"]["blocks"])}
    records = []
    real_step = trainer.train_step

    def recorded(state, batch):
        a0 = fused_adam_rows.launches
        out = real_step(state, batch)
        torch.cuda.synchronize()
        records.append((fused_adam_rows.launches - a0, out[1]["l2_loss"].item(), out[1]["grad_norm"].item()))
        return out

    trainer.train_step = recorded
    t0 = time.perf_counter()
    trainer.train()
    wall = time.perf_counter() - t0
    log(f"# training with fp32 masters (VLM trunk {sorted(dtypes)}, bf16_masters {trainer.bf16_masters}): "
        + "; ".join(f"step {i + 1} loss {loss:.6f} grad_norm {gn:.6f} fused_adam_rows {n}"
                    for i, (n, loss, gn) in enumerate(records))
        + f"; {wall:.2f} s for {steps} steps; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if (dtypes != {"torch.float32"} or trainer.bf16_masters or len(records) != steps
            or any(n != want_adam or not (np.isfinite(loss) and np.isfinite(gn)) for n, loss, gn in records)):
        raise SystemExit("the fp32-master training run did not take its steps through the row kernel")
    del trainer
    torch.cuda.empty_cache()


def compare_training_paths(depth: int = 4) -> None:
    """One fused step at full width and `depth` layers through the kernels
    (flash attention, fused_adam_rows) and through their plain versions
    (plain attention; the row update's plain math, `fused_rows_update` with
    exact scales, which fused_adam_rows_reference runs), from the same
    params, batch, noise, time and salt."""
    from intact_tpu_torch.config.pipeline import optimizer_config_from_model_json
    from intact_tpu_torch.data.dataset import InterleavedDataset
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.models.tokenizer import HashTokenizer
    from intact_tpu_torch.train import fused_joint as fj
    from intact_tpu_torch.train.trainer import preprocess_batch

    cfg = recipe_config()
    full = cfg.make_model_config()
    mc = dataclasses.replace(full, vlm=dataclasses.replace(full.vlm, depth=depth),
                             expert=dataclasses.replace(full.expert, depth=depth),
                             vision=dataclasses.replace(full.vision, depth=depth))
    opt = optimizer_config_from_model_json(cfg.model_cfg, cfg)
    policy = cm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
    data = InterleavedDataset(cfg.data, 16, seed=7, image_size=mc.vision.image_size)
    raw = preprocess_batch(next(iter(data)), HashTokenizer(mc.vlm.vocab_size, mc.tokenizer_max_length), mc)
    batch = {k: torch.from_numpy(np.asarray(v)).to(DEVICE) for k, v in raw.items()}
    rng = np.random.default_rng(8)
    noise = torch.from_numpy(rng.standard_normal(batch["actions"].shape, dtype=np.float32)).to(DEVICE)
    time_ = pi0.sample_time(rng, 16, mc, DEVICE)
    runs = {}
    for name, attn, mode in (("kernel", "pallas", "on"), ("plain", "xla", "off")):
        params = pi0.init(mc, seed=1, device=DEVICE, dtype=torch.bfloat16)
        before = {k: v.clone() for k, v in fj.tree_items(params)}
        state = fj.init_fused_state(params, seed=1)
        state.count = opt.warmup_steps  # past warmup: lr at its peak
        step = fj.make_fused_joint_step(dataclasses.replace(mc, attention_impl=attn), opt, policy,
                                        stochastic_rounding=True, pallas_mode=mode, scale_mode="exact")
        state, metrics = step(state, batch, noise=noise, time=time_, salt=12345)
        torch.cuda.synchronize()
        runs[name] = (state, metrics, before)
    (sk, mk, before), (sp, mp, _) = runs["kernel"], runs["plain"]
    loss_rel = abs(mk["l2_loss"].item() - mp["l2_loss"].item()) / abs(mp["l2_loss"].item())
    gnorm_rel = abs(mk["grad_norm"].item() - mp["grad_norm"].item()) / mp["grad_norm"].item()
    pk, pp = dict(fj.tree_items(sk.params)), dict(fj.tree_items(sp.params))
    num = sum((pk[k].float() - pp[k].float()).square().sum().item() for k in pp)
    den = sum(pp[k].float().square().sum().item() for k in pp)
    dnum = sum(((pk[k].float() - before[k].float()) - (pp[k].float() - before[k].float())).square().sum().item()
               for k in pp)
    dden = sum((pp[k].float() - before[k].float()).square().sum().item() for k in pp)
    far = total = 0
    for tree in ("mu", "nu"):
        qk = dict(fj.tree_items(getattr(sk, tree), quant_leaves=True))
        qp = dict(fj.tree_items(getattr(sp, tree), quant_leaves=True))
        for k, node in qp.items():
            if fj._is_quant_leaf(node) and node["q"].dtype != torch.float32:
                gap = (fp8_index(qk[k]["q"]) - fp8_index(node["q"])).abs()
                far += int((gap > 1).sum())
                total += gap.numel()
    share = far / total
    log(f"# training kernel vs plain path (full width, {depth} layers, batch 16, one step, same params, batch, "
        f"noise, time and salt): loss {mk['l2_loss'].item():.6f} vs {mp['l2_loss'].item():.6f} (rel {loss_rel:.3e}, "
        f"tol {TRAIN_LOSS_RTOL}), grad_norm rel {gnorm_rel:.3e} (tol {TRAIN_GNORM_RTOL}), params rel L2 "
        f"{(num / den) ** 0.5:.3e} (tol {TRAIN_PARAMS_RTOL}), update rel L2 {(dnum / dden) ** 0.5:.3e} "
        f"(tol {TRAIN_UPDATE_RTOL}), moment codes more than one apart {share:.3e} of {total} (tol {TRAIN_CODES_SHARE})")
    if not (loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= TRAIN_GNORM_RTOL and (num / den) ** 0.5 <= TRAIN_PARAMS_RTOL
            and (dnum / dden) ** 0.5 <= TRAIN_UPDATE_RTOL and share <= TRAIN_CODES_SHARE):
        raise SystemExit("the training step through the kernels disagrees with the plain path")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import intact_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    phase_build()
    kernels = {k["name"]: k for k in phase_kernels()}
    serving = phase_serving()
    torch.cuda.empty_cache()
    int8 = phase_int8_serving()
    training = phase_training()
    if not (serving > 0 and all(n > 0 for n in int8.values()) and all(n > 0 for n in training.values())):
        raise SystemExit(f"a kernel of the path never launched: serving {serving}, int8 {int8}, training {training}")
    kernels["flash_attention"]["launches"] = serving + int8["flash_attention"] + training["flash_attention"]
    kernels["fused_adam_rows"]["launches"] = training["fused_adam_rows"]
    kernels["w8a8_matmul"]["launches"] = int8["w8a8_matmul"]
    log(f"# launches on the main paths: flash_attention {serving} serving + {int8['flash_attention']} int8 "
        f"serving + {training['flash_attention']} training, fused_adam_rows {training['fused_adam_rows']} "
        f"training, w8a8_matmul {int8['w8a8_matmul']} int8 serving")
    torch.cuda.synchronize()
    log(f"# total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
