"""Drive the PyTorch port's main path on one CUDA card and hold its kernels to their plain versions.

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit):
  1. build   compile every CUDA kernel of the path from csrc/ (nvcc, sm_90a)
  2. kernels each kernel against its plain PyTorch version on the card, at the
             main path's shapes and at ragged ones, with timings and bounds
  3. serving full-width Pi0 bridge (SigLIP So400m + Gemma-2B + 300M expert,
             random bf16 weights from a seed): requests through
             Pi0Policy.select_action at batch 1 with a reset, and a batch-64
             sample_action_chunk; checks the kernel launch counts, the action
             shapes and finiteness, and the actions against the plain-attention
             path on the same params and noise; then latency at batch 1 and 64,
             and one torch.profiler pass each (device busy share, top kernels)
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

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
# the kernel and its plain version round at different places (bf16 P, bf16
# output, fp32 sums in another order): 2 bf16 ulps at |out| ~ 1
KERNEL_ATOL = 2e-2
# relative L2 distance between bf16 actions from the kernel path and the plain
# path: the two round q*scale and the logits at different places in 17 layers,
# and 10 Euler steps carry that through the expert (bf16 rounding is 2^-9)
ACTIONS_RTOL = 5e-2


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


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from intact_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.build_all()
    log(f"# build: {time.perf_counter() - t0:.2f} s for {len(build.SOURCES)} source(s)")
    for name, text in build.ptxas_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"# ptxas {name}: {line.strip()}")
    log(f"# card: {gpu_name_and_power()}")


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


def phase_kernels() -> dict:
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

    q, k, v, mask = bridge
    ms = cuda_ms(lambda: flash_attention(q, k, v, mask))
    plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, mask), reps=10)
    qt, kt, vt, mt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask[:, None]
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mt, enable_gqa=True))
    s = k.shape[1]
    moved = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size() + mask.numel()
    flops = 4 * b * h * t * s * d
    bytes_ms, ops_ms = moved / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    log(f"# flash_attention bridge timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({moved / 1e6:.1f} MB -> {bytes_ms:.4f} ms, {flops / 1e9:.1f} GFLOP -> {ops_ms:.4f} ms)")
    flash_attention.launches = 0  # comparison launches do not count
    return {
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
        profile_inference(policy, obs, b)
    return launches


def profile_inference(policy, obs: dict, b: int) -> None:
    """Device busy share and the kernels that take the most device time in
    one inference, under torch.profiler (which adds host time of its own)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        policy.sample_action_chunk(obs)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"# profile batch {b}: wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"#   {e.self_device_time_total / 1e3:8.3f} ms {100 * e.self_device_time_total / busy_us:5.1f}% "
            f"x{e.count:<5d} {e.key[:90]}")


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
    kernel = phase_kernels()
    kernel["launches"] = phase_serving()
    torch.cuda.synchronize()
    log(f"# total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
