"""In-place 8-bit-state AdamW row update: the hand-written CUDA kernel (csrc/fused_adam_rows.cu) and its plain version.

Replaces intact_tpu/ops/pallas_adam.py::fused_adam_rows. One call updates one
parameter leaf `p[L, r, B]` (bf16, or fp32 with fp32 masters; the gradient in
p's dtype) at row `layer`, and its moments: rows
[row_offset, row_offset + r) of layer `layer` of the packed moment arrays
qm/qn [L, NB, B] (fp8 e4m3/e5m2 codes with fp32 row scales sm/sn [L, NB], or
fp32 with the scales left alone). It adds the sum of the squared raw gradient
into `ss`. Everything is updated in place; nothing else is touched.

`hyp` is a 4-float tensor on the leaf's device holding c1, c2, lr and the clip
factor, so a step never syncs with the host for them. With `stochastic` and
bf16 p, p is rounded stochastically with the hash noise of
`fused_joint._hash_noise_u16` over the leaf's (row, col) index, salted by the
uint32 `salt` (`hash_noise_u16` here).

`fused_adam_rows` launches the kernel for CUDA tensors (or raises: there is no
fallback) and runs `fused_adam_rows_reference` for CPU tensors.
`fused_adam_rows.launches` counts kernel launches, and nothing else. The
kernel's deterministic ss sum needs a small workspace (`workspace`), allocated
once per device and stream. `math_check` holds the kernel's fast division and
square root to the correctly rounded ones on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from intact_tpu_torch.ops import build

ROW_TILE = 128
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}
TINY = torch.finfo(torch.float32).tiny
_M32 = 0xFFFFFFFF


def eligible(n_elems: int, block_size: int) -> bool:
    """True if a leaf of n_elems takes the kernel's row-update path."""
    return n_elems % block_size == 0 and (n_elems // block_size) % ROW_TILE == 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h in [0, 2**32), with no int64 overflow."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def hash_noise_u16(shape, salt: int, device=None) -> torch.Tensor:
    """fused_joint._hash_noise_u16: uniform 16-bit noise (int64 values in
    [0, 2**16)) from a murmur-style hash of the element index, salted by the
    uint32 `salt`. For 2-D shapes the index is the flat index r * W + c, as
    in the reference and in the kernel; a 1-D shape (n,) hashes i * (n + 1),
    as the reference does (its row and column index are both i); shapes of
    more dimensions hash the flat index of (prod(leading), last), where the
    reference would repeat the noise along every axis but the first and the
    last."""
    width = shape[-1]
    if len(shape) == 1:
        idx = torch.arange(width, dtype=torch.int64, device=device) * (width + 1)
    else:
        rows = int(np.prod(shape[:-1]))
        idx = (torch.arange(rows, dtype=torch.int64, device=device)[:, None] * width
               + torch.arange(width, dtype=torch.int64, device=device)[None, :]).view(shape)
    h = (idx + ((int(salt) & _M32) * 0x9E3779B9 & _M32)) & _M32
    h = _mul32(h, 2654435761)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x45D9F3B)
    h = h ^ (h >> 16)
    return h & 0xFFFF


_MIX_INV = pow(0x9E3779B9, -1, 1 << 32)  # the salt multiplier is odd, so invertible mod 2**32


def shift_salt(salt: int, offset: int) -> int:
    """The salt whose hash noise at flat index i equals `salt`'s at i + offset
    (2-D shapes): the noise adds salt * 0x9E3779B9 to the index, so a row
    range that starts `offset` elements into a leaf rounds, under the shifted
    salt, with the bits the whole leaf's rounding gives it."""
    return (int(salt) + int(offset) * _MIX_INV) & _M32


def sr_to_bf16(exact: torch.Tensor, salt: int) -> torch.Tensor:
    """fused_joint._sr_add's rounding of fp32 `exact` to bf16: add 16 bits of
    hash noise to the fp32 bits and keep the top 16."""
    bits = exact.contiguous().view(torch.int32).to(torch.int64) & _M32
    top = ((bits + hash_noise_u16(exact.shape, salt, exact.device)) >> 16) & 0xFFFF
    return torch.where(top >= 1 << 15, top - (1 << 16), top).to(torch.int16).view(torch.bfloat16)


def adam_math(g, mu, nu, c1, c2, hp):
    """fused_joint._adam_math, same association."""
    mu = hp.betas[0] * mu + (1.0 - hp.betas[0]) * g
    nu = hp.betas[1] * nu + (1.0 - hp.betas[1]) * torch.square(g)
    direction = (mu / c1) / (torch.sqrt(nu / c2) + hp.eps)
    return mu, nu, direction


def round_params(p_dtype: torch.dtype, exact: torch.Tensor, salt: int, stochastic: bool) -> torch.Tensor:
    """fp32 update result -> p's dtype: stochastic rounding for bf16 when
    asked, else round to nearest."""
    if stochastic and p_dtype == torch.bfloat16:
        return sr_to_bf16(exact, salt)
    return exact.to(p_dtype)


def fused_rows_update(p2, g2, qm, sm, qn, sn, *, c1, c2, lr, clip_factor, hp, salt: int, stochastic: bool,
                      scale_mode: str = "bound"):
    """fused_joint._fused_rows_update on [R, block] row views: the whole
    decode -> adam -> p update -> encode chain. sm/sn [R, 1]. scale_mode
    "exact" re-encodes with the row absmax (what the kernel does); "bound"
    with the analytic decay recurrence
        448 * s_mu' = b1 * (448 * s_mu) + (1 - b1) * rowmax|g|     (e4m3)
        57344 * s_nu' = b2 * (57344 * s_nu) + (1 - b2) * rowmax(g)^2  (e5m2).
    Returns new (p2', qm', sm', qn', sn')."""
    fp8 = qm.dtype != torch.float32
    g32 = g2.to(torch.float32) * clip_factor
    if fp8:
        mu = qm.to(torch.float32) * sm
        nu = qn.to(torch.float32) * sn
    else:
        mu, nu = qm, qn
    mu, nu, direction = adam_math(g32, mu, nu, c1, c2, hp)
    p32 = p2.to(torch.float32)
    p_new = round_params(p2.dtype, p32 + (-lr) * (direction + hp.weight_decay * p32), salt, stochastic)
    if not fp8:
        return p_new, mu, sm, nu, sn
    m_max, n_max = FP8_MAX[qm.dtype], FP8_MAX[qn.dtype]
    if scale_mode == "bound":
        gmax = g32.abs().amax(dim=1, keepdim=True)
        sm2 = hp.betas[0] * sm + (1.0 - hp.betas[0]) * gmax / m_max
        sn2 = hp.betas[1] * sn + (1.0 - hp.betas[1]) * torch.square(gmax) / n_max
    else:
        sm2 = mu.abs().amax(dim=1, keepdim=True) / m_max
        sn2 = nu.amax(dim=1, keepdim=True) / n_max
    sm2, sn2 = sm2.clamp_min(TINY), sn2.clamp_min(TINY)
    return p_new, (mu / sm2).to(qm.dtype), sm2, (nu / sn2).to(qn.dtype), sn2


def fused_adam_rows_reference(p, g, qm, sm, qn, sn, *, layer: int, row_offset: int, hyp: torch.Tensor,
                              ss: torch.Tensor, hp, salt: int = 0, stochastic: bool = False) -> None:
    """Plain-torch version of the kernel (in place, same arguments):
    `fused_rows_update` with exact scales on the leaf's rows."""
    _check_shapes(p, g, qm, sm, qn, sn, layer, row_offset)
    rows = slice(row_offset, row_offset + p.shape[1])
    c1, c2, lr, clip = hyp.to(torch.float32).unbind()
    ss.add_(torch.square(g.to(torch.float32)).sum())
    p2, qm2, sm2, qn2, sn2 = fused_rows_update(
        p[layer], g, qm[layer, rows], sm[layer, rows, None], qn[layer, rows], sn[layer, rows, None],
        c1=c1, c2=c2, lr=lr, clip_factor=clip, hp=hp, salt=salt, stochastic=stochastic, scale_mode="exact")
    p[layer] = p2
    qm[layer, rows], qn[layer, rows] = qm2, qn2
    sm[layer, rows], sn[layer, rows] = sm2[:, 0], sn2[:, 0]


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _check_shapes(p, g, qm, sm, qn, sn, layer, row_offset):
    if p.ndim != 3 or g.shape != p.shape[1:]:
        raise ValueError(f"expected p [L, r, B] and g [r, B]; got {tuple(p.shape)}, {tuple(g.shape)}")
    L, r, B = p.shape
    if qm.ndim != 3 or qm.shape != qn.shape or qm.shape[2] != B:
        raise ValueError(f"moments must be [L, NB, B={B}]; got {tuple(qm.shape)}, {tuple(qn.shape)}")
    if sm.shape != qm.shape[:2] or sn.shape != qm.shape[:2]:
        raise ValueError(f"scales must be [L, NB] = {tuple(qm.shape[:2])}; got {tuple(sm.shape)}, {tuple(sn.shape)}")
    if not (0 <= layer < L and layer < qm.shape[0]):
        raise ValueError(f"layer {layer} outside [0, {min(L, qm.shape[0])})")
    if not (0 <= row_offset and row_offset + r <= qm.shape[1]):
        raise ValueError(f"rows [{row_offset}, {row_offset + r}) outside the {qm.shape[1]} moment rows")
    if (qm.dtype, qn.dtype) not in ((torch.float8_e4m3fn, torch.float8_e5m2), (torch.float32, torch.float32)):
        raise TypeError(f"moments must be (float8_e4m3fn, float8_e5m2) or fp32; got {qm.dtype}, {qn.dtype}")


def _check_kernel(p, g, qm, sm, qn, sn, hyp, ss, row_offset):
    L, r, B = p.shape
    if p.dtype != g.dtype or p.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA kernel takes bf16 or fp32 p with a gradient of the same dtype; got {p.dtype}, "
                        f"{g.dtype}")
    if not sm.dtype == sn.dtype == hyp.dtype == ss.dtype == torch.float32:
        raise TypeError("the CUDA kernel takes fp32 scales, hyp and ss")
    if hyp.numel() != 4 or ss.numel() != 1:
        raise ValueError(f"hyp must hold 4 floats and ss 1; got {hyp.numel()}, {ss.numel()}")
    if r % ROW_TILE or row_offset % ROW_TILE:
        raise ValueError(f"rows ({r}) and row_offset ({row_offset}) must be multiples of {ROW_TILE}")
    if B % 256 or B > 2048:
        raise ValueError(f"the CUDA kernel takes a block size B that is a multiple of 256, at most 2048; got {B}")
    tensors = (p, g, qm, sm, qn, sn, hyp, ss)
    if any(x.device != p.device for x in tensors):
        raise ValueError("all tensors must lie on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    if any(x.data_ptr() % 16 for x in (p, g, qm, qn)):
        raise ValueError("the CUDA kernel needs 16-byte aligned p, g and moments")


MAX_CTAS = 4096  # the persistent grid's cap: one fp32 ss partial per CTA
_workspaces: dict = {}


def workspace(device: torch.device, stream: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(partials, ticket) of the kernel's deterministic ss sum, allocated once
    per device and stream and reused by every call there: MAX_CTAS fp32
    partials, and a ticket that starts at 0 and that each launch's last CTA
    re-arms to 0. Launches on one stream run one after another, so they can
    share them."""
    key = (device, stream)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = (torch.empty(MAX_CTAS, dtype=torch.float32, device=device),
                                 torch.zeros(1, dtype=torch.int32, device=device))
    return ws


def _lib():
    lib = build.load("fused_adam_rows")
    if not getattr(lib, "_intact_typed", False):
        v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.intact_fused_adam_rows.argtypes = [v] * 8 + [i, v, v] + [i] * 5 + [f] * 6 + [ctypes.c_uint, i, i, i, v]
        lib.intact_fused_adam_rows.restype = i
        lib.intact_fused_adam_math_check.argtypes = [v, v, i, i, f, f, f, v, v]
        lib.intact_fused_adam_math_check.restype = i
        lib.intact_cuda_error_string.argtypes = [i]
        lib.intact_cuda_error_string.restype = ctypes.c_char_p
        lib._intact_typed = True
    return lib


def fused_adam_rows(p, g, qm, sm, qn, sn, *, layer: int, row_offset: int, hyp: torch.Tensor,
                    ss: torch.Tensor, hp, salt: int = 0, stochastic: bool = False) -> None:
    """Update p[layer] and its moment rows in place; ss += sum(g**2).

    p [L, r, B] bf16 or fp32, g [r, B] of p's dtype; qm/qn [L, NB, B]; sm/sn
    [L, NB]; hyp fp32 [4] (c1, c2, lr, clip); ss fp32 accumulator of one
    element; hp carries betas, eps and weight_decay; salt a uint32 for the SR
    noise (bf16 p only)."""
    if p.device.type == "cpu":
        return fused_adam_rows_reference(p, g, qm, sm, qn, sn, layer=layer, row_offset=row_offset,
                                         hyp=hyp, ss=ss, hp=hp, salt=salt, stochastic=stochastic)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam_rows runs on CUDA or CPU tensors, not {p.device}")
    _check_shapes(p, g, qm, sm, qn, sn, layer, row_offset)
    _check_kernel(p, g, qm, sm, qn, sn, hyp, ss, row_offset)
    L, r, B = p.shape
    b1, b2 = (float(b) for b in hp.betas)
    device = p.device
    stream = torch._C._cuda_getCurrentRawStream(device.index)  # what current_stream(device).cuda_stream returns
    partials, ticket = workspace(device, stream)
    args = (p.data_ptr(), g.data_ptr(), qm.data_ptr(), sm.data_ptr(), qn.data_ptr(), sn.data_ptr(), hyp.data_ptr(),
            partials.data_ptr(), MAX_CTAS, ticket.data_ptr(), ss.data_ptr(), r, B, qm.shape[1], layer, row_offset,
            b1, 1.0 - b1, b2, 1.0 - b2, float(hp.eps), float(hp.weight_decay), int(salt) & _M32,
            int(bool(stochastic) and p.dtype == torch.bfloat16), int(qm.dtype != torch.float32),
            int(p.dtype == torch.float32), stream)
    lib = _lib()
    if device.index == torch.cuda.current_device():
        err = lib.intact_fused_adam_rows(*args)
    else:
        with torch.cuda.device(device):
            err = lib.intact_fused_adam_rows(*args)
    if err:
        raise RuntimeError(f"fused_adam_rows kernel launch failed: {lib.intact_cuda_error_string(err).decode()}")
    fused_adam_rows.launches += 1


MATH_CHECK_MODES = {"divide": 0, "sqrt": 1, "direction": 2}


def math_check(a: torch.Tensor, d: torch.Tensor, mode: str, c1: float = 1.0, c2: float = 1.0,
               eps: float = 1e-8) -> tuple[int, int]:
    """Holds the kernel's fast and zero paths to the correctly rounded
    operations (__fdiv_rn, __fsqrt_rn) on the card, case by case, where the
    kernel takes them: mode "divide" a / d (shared divisor, hoisted
    reciprocal; a zero a passes through), "sqrt" sqrt(a), "direction"
    (a / c1) / (sqrt(d / c2) + eps) for moments a, d (both in range, or both
    zero). -> (cases in the paths' domain, cases among them that differ in
    any bit). a and d: fp32 CUDA tensors of one shape."""
    if a.device.type != "cuda" or a.shape != d.shape or not a.dtype == d.dtype == torch.float32:
        raise ValueError("math_check takes two fp32 CUDA tensors of one shape")
    a, d = a.contiguous(), d.contiguous()
    out = torch.zeros(2, dtype=torch.int32, device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.intact_fused_adam_math_check(a.data_ptr(), d.data_ptr(), a.numel(), MATH_CHECK_MODES[mode],
                                               c1, c2, eps, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"math check launch failed: {lib.intact_cuda_error_string(err).decode()}")
    tested, wrong = out.tolist()
    return tested, wrong


fused_adam_rows.launches = 0
