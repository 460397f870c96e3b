"""Blockwise 8-bit AdamW state (intact_tpu/train/optim8bit.py) in plain PyTorch.

Adam's moments are stored as int8 codes with a per-block absmax scale and
decoded to fp32 only for the update:

  * dynamic (log-banded) 256-entry codebooks, signed for mu and unsigned for
    nu, 7 decades of range (`make_dynamic_codebook`, the reference's values);
  * per-block absmax scales over `block_size` contiguous elements of the
    flattened leaf (zero padded at the end), stored fp32 as [nb, 1];
  * leaves below `min_quant_elems` elements keep exact fp32 moments.

The update runs over a leaf's block rows a chunk at a time, so its fp32
temporaries hold one chunk. In the reference this module is XLA code, not a
Pallas kernel, so plain torch ops are its counterpart here.

Stochastic rounding of bf16 masters (`add_rounded`, `stochastic_round`) adds
16 random low bits to the fp32 sum and truncates, as the reference's
`apply_updates_stochastic` does; the bits come from an explicit
`torch.Generator`, so the stream differs from JAX's keys by design.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

BLOCK_SIZE = 2048
MIN_QUANT_ELEMS = 65536
ROWS_PER_CHUNK = 8192  # block rows per update chunk: 16 M elements at block 2048
TINY = float(np.finfo(np.float32).tiny)


# ---------------------------------------------------------------------------
# dynamic codebooks
# ---------------------------------------------------------------------------

def make_dynamic_codebook(signed: bool, decades: int = 7) -> np.ndarray:
    """256-entry code over [-1, 1] (signed) or [0, 1] (unsigned), sorted
    ascending: log bands 10^-decades .. 1, each band linearly subdivided with
    geometrically more points in the high-magnitude bands. code[i] is the
    value of stored index i - 128."""
    per_sign = 127 if signed else 254
    weights = np.array([2.0**e for e in range(decades)])
    counts = np.maximum(1, np.round(weights / weights.sum() * per_sign)).astype(int)
    counts[-1] += per_sign - counts.sum()  # rounding drift onto the finest band
    vals = []
    for e, n in enumerate(counts):
        lo = 10.0 ** (e - decades)
        hi = 10.0 ** (e - decades + 1)
        vals.append(np.linspace(lo, hi, n, endpoint=(e == decades - 1)))
    pos = np.concatenate(vals)
    pos[-1] = 1.0  # exact top
    if signed:
        code = np.concatenate([-pos[::-1], [0.0], pos, [1.0]])  # 255 entries + a duplicate top
    else:
        code = np.concatenate([[0.0], pos, [1.0]])
    code = np.sort(code.astype(np.float32))
    if code.shape != (256,):
        raise AssertionError(code.shape)
    return code


_CODE = {True: make_dynamic_codebook(signed=True), False: make_dynamic_codebook(signed=False)}
# quantization boundaries: midpoints between adjacent code values
_BOUNDS = {s: ((c[1:] + c[:-1]) / 2).astype(np.float32) for s, c in _CODE.items()}


@functools.cache
def _tables(device: torch.device, signed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(code, bounds) on `device`, made once per device: a host-to-device
    copy per leaf would wait for the device's queue."""
    return torch.from_numpy(_CODE[signed]).to(device), torch.from_numpy(_BOUNDS[signed]).to(device)


def zero_index(signed: bool) -> int:
    """The stored int8 code index that decodes to exactly 0."""
    return int(np.searchsorted(_BOUNDS[signed], 0.0)) - 128


# ---------------------------------------------------------------------------
# blockwise encode / decode
# ---------------------------------------------------------------------------

def encode_rows(blocks: torch.Tensor, signed: bool) -> dict:
    """fp32 [nb, block] -> {"q": int8 [nb, block], "scale": fp32 [nb, 1]}."""
    _, bounds = _tables(blocks.device, signed)
    scale = blocks.abs().amax(dim=1, keepdim=True)
    u = blocks / scale.clamp_min(TINY)
    idx = torch.searchsorted(bounds, u.contiguous())  # [0, 255]
    return {"q": (idx - 128).to(torch.int8), "scale": scale}


def decode_rows(q: torch.Tensor, scale: torch.Tensor, signed: bool) -> torch.Tensor:
    code, _ = _tables(q.device, signed)
    return code[q.to(torch.long) + 128] * scale


def encode(x: torch.Tensor, signed: bool, block_size: int = BLOCK_SIZE) -> dict:
    """fp32 leaf -> {"q": int8 [nb, block], "scale": fp32 [nb, 1]} (optim8bit._encode)."""
    flat = x.to(torch.float32).reshape(-1)
    nb = -(-flat.numel() // block_size)
    flat = torch.nn.functional.pad(flat, (0, nb * block_size - flat.numel()))
    return encode_rows(flat.view(nb, block_size), signed)


def decode(qs: dict, signed: bool, shape) -> torch.Tensor:
    """optim8bit._decode: codes -> fp32 leaf of `shape`."""
    size = int(np.prod(shape))
    return decode_rows(qs["q"], qs["scale"], signed).reshape(-1)[:size].reshape(shape)


# ---------------------------------------------------------------------------
# the moments and their update
# ---------------------------------------------------------------------------

def should_quantize(p: torch.Tensor) -> bool:
    return p.numel() >= MIN_QUANT_ELEMS


def init_moment(p: torch.Tensor, signed: bool, rows: int | None = None):
    """Zero moment of leaf p: codes of exact zero with zero scales (all its
    block rows, or `rows` of them: one rank's share), or fp32 zeros below
    MIN_QUANT_ELEMS elements."""
    if should_quantize(p):
        nb = -(-p.numel() // BLOCK_SIZE) if rows is None else rows
        return {"q": torch.full((nb, BLOCK_SIZE), zero_index(signed), dtype=torch.int8, device=p.device),
                "scale": torch.zeros((nb, 1), dtype=torch.float32, device=p.device)}
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adam8bit_leaf(g: torch.Tensor, mu_s, nu_s, *, c1: float, c2: float, b1: float, b2: float, eps: float):
    """scale_by_adam8bit on one leaf, moments updated in place. Yields
    (slice of the flattened leaf, fp32 direction (mu/c1) / (sqrt(nu/c2) + eps))
    chunk by chunk; the moments of a chunk are re-encoded before the next one
    is decoded."""
    if not isinstance(mu_s, dict):
        g32 = g.to(torch.float32)
        mu_s.copy_(b1 * mu_s + (1.0 - b1) * g32)
        nu_s.copy_(b2 * nu_s + (1.0 - b2) * torch.square(g32))
        yield slice(0, g.numel()), ((mu_s / c1) / (torch.sqrt(nu_s / c2) + eps)).reshape(-1)
        return
    nb, block = mu_s["q"].shape
    n = g.numel()
    flat = g.reshape(-1)
    for r0 in range(0, nb, ROWS_PER_CHUNK):
        r1 = min(r0 + ROWS_PER_CHUNK, nb)
        e0, e1 = r0 * block, min(r1 * block, n)
        gc = torch.nn.functional.pad(flat[e0:e1].to(torch.float32), (0, (r1 - r0) * block - (e1 - e0)))
        gc = gc.view(r1 - r0, block)
        mu = b1 * decode_rows(mu_s["q"][r0:r1], mu_s["scale"][r0:r1], True) + (1.0 - b1) * gc
        nu = b2 * decode_rows(nu_s["q"][r0:r1], nu_s["scale"][r0:r1], False) + (1.0 - b2) * torch.square(gc)
        out = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        for s, new, signed in ((mu_s, mu, True), (nu_s, nu, False)):
            enc = encode_rows(new, signed)
            s["q"][r0:r1], s["scale"][r0:r1] = enc["q"], enc["scale"]
        yield slice(e0, e1), out.reshape(-1)[:e1 - e0]


# ---------------------------------------------------------------------------
# stochastic rounding for bf16 master params
# ---------------------------------------------------------------------------

def stochastic_round(exact: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """fp32 -> bf16 with stochastic rounding: 16 uniform random bits added to
    the fp32 bit pattern below the bf16 mantissa, then truncated, so the
    expected value is the exact one."""
    bits = exact.contiguous().view(torch.int32)
    noise = torch.randint(0, 1 << 16, bits.shape, generator=generator, dtype=torch.int32, device=bits.device)
    return ((bits + noise) & -65536).view(torch.float32).to(torch.bfloat16)


def add_rounded(p: torch.Tensor, u: torch.Tensor, generator: torch.Generator | None,
                stochastic: bool) -> torch.Tensor:
    """p + u in fp32, rounded to p's dtype: stochastically for bf16 p when
    asked (optim8bit.apply_updates_stochastic, one leaf or slice at a time),
    to nearest otherwise (fp32 p is exact)."""
    exact = p.to(torch.float32) + u.to(torch.float32)
    if stochastic and p.dtype == torch.bfloat16:
        return stochastic_round(exact, generator)
    return exact.to(p.dtype)

