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

A rank's slice of a leaf split over fsdp ranks (ZeRO-3, train/optim.py)
keeps its codes in the slice's layout and one scale per block of the WHOLE
flattened leaf ([nb, 1] on every rank): `adam8bit_slice` forms each block's
absmax from this rank's elements, takes the max over the ranks (one [2, nb]
all-reduce per leaf), then encodes each element against its block's scale.
The codebook is elementwise given the scale, so the moments are bit for bit
one rank's, and a gather of the codes alone gives the one-rank layout
(`slice_to_rows`, `rows_to_slice`).

Stochastic rounding of bf16 masters (`add_rounded`, `stochastic_round`) adds
16 random low bits to the fp32 sum and truncates, as the reference's
`apply_updates_stochastic` does; the bits come from an explicit
`torch.Generator`, so the stream differs from JAX's keys by design.
"""

from __future__ import annotations

import dataclasses
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


def init_moment(p: torch.Tensor, signed: bool):
    """Zero moment of leaf p: codes of exact zero with zero scales for all its
    block rows, or fp32 zeros below MIN_QUANT_ELEMS elements."""
    if should_quantize(p):
        nb = -(-p.numel() // BLOCK_SIZE)
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
# a rank's slice of a leaf against the whole leaf's blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SliceLayout:
    """Where a rank's slice lies in its leaf's flat order: a box of shape
    `local` at `offsets` in the whole leaf of shape `shape` (a tensor slice's
    fsdp part splits two dimensions; element e of the flattened slice is the
    leaf's element at the box's e-th position in row-major order)."""

    shape: tuple
    local: tuple
    offsets: tuple

    @property
    def n(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nb(self) -> int:
        return -(-self.n // BLOCK_SIZE)

    @property
    def start(self) -> int:
        """The leaf's flat index of the slice's first element."""
        return self.at(0)

    @property
    def contiguous(self) -> bool:
        """The slice is one run of the leaf's flat order."""
        split = [i for i, (a, b) in enumerate(zip(self.local, self.shape)) if a != b]
        if not split:
            return True
        first = split[0]
        return all(self.local[i] == 1 for i in range(first)) and split == [first]

    def at(self, e: int) -> int:
        """The leaf's flat index of the slice's element e."""
        out, stride = 0, 1
        for size, whole, off in zip(reversed(self.local), reversed(self.shape), reversed(self.offsets)):
            out += (e % size + off) * stride
            e //= size
            stride *= whole
        return out

    def where(self, e0: int, e1: int, device) -> torch.Tensor:
        """The leaf's flat indices of the slice's elements [e0, e1) (int64)."""
        e = torch.arange(e0, e1, dtype=torch.int64, device=device)
        out = torch.zeros_like(e)
        stride = 1
        for size, whole, off in zip(reversed(self.local), reversed(self.shape), reversed(self.offsets)):
            out += (e % size + off) * stride
            e = torch.div(e, size, rounding_mode="floor")
            stride *= whole
        return out


def slice_layout(shape, dim: int, parts: int, index: int, tensor=None) -> SliceLayout:
    """The layout of part `index` of `parts` along `dim` of a leaf's slice of
    shape `shape`: of the whole leaf, or of its tensor slice `tensor` (a
    sharding.TensorSplit, whose shape is the whole leaf's)."""
    local, offsets = list(shape), [0] * len(shape)
    local[dim] //= parts
    offsets[dim] = index * local[dim]
    if tensor is None:
        return SliceLayout(tuple(shape), tuple(local), tuple(offsets))
    offsets[tensor.dim] += tensor.index * shape[tensor.dim]
    return SliceLayout(tuple(tensor.shape), tuple(local), tuple(offsets))


def _blocks(layout: SliceLayout, e0: int, e1: int, device):
    """The whole leaf's blocks [b0, b1) under the slice's elements [e0, e1),
    and the leaf's index of each element, or None where they are the leaf's
    elements b0 * BLOCK_SIZE onwards, in order."""
    if layout.contiguous and (layout.start + e0) % BLOCK_SIZE == 0:
        b0 = (layout.start + e0) // BLOCK_SIZE
        return b0, b0 + -(-(e1 - e0) // BLOCK_SIZE), None
    return layout.at(e0) // BLOCK_SIZE, layout.at(e1 - 1) // BLOCK_SIZE + 1, layout.where(e0, e1, device)


def _per_element(scale: torch.Tensor, b0: int, b1: int, where, count: int) -> torch.Tensor:
    """Each element's block scale (scale: fp32 [nb])."""
    if where is None:
        return scale[b0:b1].repeat_interleave(BLOCK_SIZE)[:count]
    return scale[torch.div(where, BLOCK_SIZE, rounding_mode="floor")]


def _block_absmax(x: torch.Tensor, b0: int, b1: int, where) -> torch.Tensor:
    """max |x| over this rank's elements of each block b0..b1-1 (0 where it has none)."""
    buf = torch.zeros((b1 - b0) * BLOCK_SIZE, dtype=torch.float32, device=x.device)
    if where is None:
        buf[:x.numel()] = x.abs()
    else:
        buf.index_copy_(0, where - b0 * BLOCK_SIZE, x.abs())
    return buf.view(b1 - b0, BLOCK_SIZE).amax(dim=1)


def init_slice_moment(local: torch.Tensor, whole_numel: int, signed: bool) -> dict:
    """Zero 8-bit moment of a rank's slice: codes of exact zero in the slice's
    shape, zero scales for every block of the whole leaf."""
    nb = -(-whole_numel // BLOCK_SIZE)
    return {"q": torch.full(local.shape, zero_index(signed), dtype=torch.int8, device=local.device),
            "scale": torch.zeros((nb, 1), dtype=torch.float32, device=local.device)}


def adam8bit_slice(g: torch.Tensor, mu_s: dict, nu_s: dict, layout: SliceLayout, reduce_max, *, c1: float,
                   c2: float, b1: float, b2: float, eps: float):
    """scale_by_adam8bit on a rank's slice g of a leaf (codes in the slice's
    layout, scales of the whole leaf's blocks), moments updated in place.
    Two passes over chunks of ROWS_PER_CHUNK * BLOCK_SIZE elements: the first
    forms the new moments and each block's absmax over this rank's elements,
    `reduce_max([2, nb])` takes the max over the ranks in place; the second
    forms them again, encodes each element against its block's new scale and
    yields (slice of the flattened slice, fp32 direction), as
    adam8bit_leaf does."""
    n, step, device = g.numel(), ROWS_PER_CHUNK * BLOCK_SIZE, g.device
    flat = g.reshape(-1)
    codes = (mu_s["q"].view(-1), nu_s["q"].view(-1))
    old = (mu_s["scale"].view(-1), nu_s["scale"].view(-1))
    tables = (_tables(device, True), _tables(device, False))

    def moments(e0, e1, b0, b1_, where):
        gc = flat[e0:e1].to(torch.float32)
        dec = [tables[r][0][codes[r][e0:e1].to(torch.long) + 128] * _per_element(old[r], b0, b1_, where, e1 - e0)
               for r in (0, 1)]
        return b1 * dec[0] + (1.0 - b1) * gc, b2 * dec[1] + (1.0 - b2) * torch.square(gc)

    absmax = torch.zeros((2, layout.nb), dtype=torch.float32, device=device)
    for e0 in range(0, n, step):
        e1 = min(e0 + step, n)
        blocks = _blocks(layout, e0, e1, device)
        for r, new in enumerate(moments(e0, e1, *blocks)):
            part = absmax[r, blocks[0]:blocks[1]]
            torch.maximum(part, _block_absmax(new, *blocks), out=part)
    reduce_max(absmax)
    for e0 in range(0, n, step):
        e1 = min(e0 + step, n)
        blocks = _blocks(layout, e0, e1, device)
        mu, nu = moments(e0, e1, *blocks)
        out = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        for r, new in enumerate((mu, nu)):
            u = new / _per_element(absmax[r], *blocks, e1 - e0).clamp_min(TINY)
            codes[r][e0:e1] = (torch.searchsorted(tables[r][1], u.contiguous()) - 128).to(torch.int8)
        yield slice(e0, e1), out
    for r in (0, 1):
        old[r].copy_(absmax[r])


def slice_to_rows(q_whole: torch.Tensor, signed: bool) -> torch.Tensor:
    """A leaf's gathered codes (its shape) -> the one-rank layout [nb, BLOCK_SIZE]
    (the tail padded with the code of exact zero, as one rank's holds it)."""
    flat = q_whole.reshape(-1)
    nb = -(-flat.numel() // BLOCK_SIZE)
    out = torch.full((nb * BLOCK_SIZE,), zero_index(signed), dtype=torch.int8, device=flat.device)
    out[:flat.numel()] = flat
    return out.view(nb, BLOCK_SIZE)


def rows_to_slice(q_rows: torch.Tensor, shape) -> torch.Tensor:
    """One-rank codes [nb, BLOCK_SIZE] -> the leaf's codes in its shape (a view)."""
    return q_rows.reshape(-1)[:int(np.prod(shape, dtype=np.int64))].view(tuple(shape))


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

