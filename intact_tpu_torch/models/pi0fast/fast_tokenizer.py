"""FAST-style action tokenizer: DCT + quantization + byte-pair encoding.

Upstream Pi0-FAST compresses normalized action chunks with the
`physical-intelligence/fast` processor: per-dimension DCT over the time
axis, coefficient quantization, and a BPE vocabulary trained on robot data
(the reference consumes it through LeRobot's PI0FAST policy). This module
implements that scheme natively and HERMETICALLY:

  encode: actions [H, D] -> DCT-II (orthonormal) per dim -> round(scale*c)
          -> zigzag-interleave (low frequencies of every dim first, where
          the energy is) -> map ints to symbols -> BPE merge -> ids
  decode: exact inverse (lossy only through coefficient quantization)

The BPE table is trained with `fit()` on an action corpus (e.g. the bridge
training set) and serialized to JSON, so no network/hub asset is needed.
(intact_tpu/models/pi0fast/fast_tokenizer.py, copied; its hub loader of the
released processor is left out, since the port loads nothing from the hub.)

Tokens index the TAIL of the model vocabulary (same convention as the
binning scheme in pi0fast.model / serve.decoding), so FAST ids drop into
the PaliGemma embedding table unchanged.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def _dct2(x: np.ndarray) -> np.ndarray:
    from scipy.fft import dct

    return dct(x, type=2, norm="ortho", axis=0)


def _idct2(c: np.ndarray) -> np.ndarray:
    from scipy.fft import idct

    return idct(c, type=2, norm="ortho", axis=0)


class FastTokenizer:
    """scale: quantization resolution for DCT coefficients (bigger = finer);
    max_token: BPE vocabulary size (merged symbols + base alphabet)."""

    def __init__(self, scale: float = 10.0, max_token: int = 1024,
                 coef_range: int = 128):
        self.scale = scale
        self.max_token = max_token
        # quantized coefficients clip to [-coef_range, coef_range) and map
        # to base symbols 0..2*coef_range-1
        self.coef_range = coef_range
        self.base = 2 * coef_range
        self.merges: list[tuple[int, int]] = []  # (a, b) -> base + rank

    # -- integer sequence layer ------------------------------------------

    def _quantize(self, actions: np.ndarray) -> np.ndarray:
        """[H, D] -> int sequence (zigzag: coef 0 of every dim, coef 1...)."""
        coefs = np.round(_dct2(np.asarray(actions, np.float64)) * self.scale)
        coefs = np.clip(coefs, -self.coef_range, self.coef_range - 1)
        return (coefs.astype(np.int64) + self.coef_range).reshape(-1)  # [H*D]

    def _dequantize(self, symbols: np.ndarray, horizon: int, dim: int) -> np.ndarray:
        coefs = (symbols.astype(np.float64) - self.coef_range).reshape(horizon, dim)
        return _idct2(coefs / self.scale).astype(np.float32)

    # -- BPE layer ---------------------------------------------------------

    def fit(self, corpus: np.ndarray, verbose: bool = False) -> "FastTokenizer":
        """Train BPE merges on [N, H, D] normalized action chunks."""
        seqs = [list(self._quantize(a)) for a in np.asarray(corpus)]
        self.merges = []
        next_id = self.base
        while next_id < self.max_token:
            counts: dict[tuple[int, int], int] = {}
            for s in seqs:
                for pair in zip(s, s[1:]):
                    counts[pair] = counts.get(pair, 0) + 1
            if not counts:
                break
            best, n = max(counts.items(), key=lambda kv: kv[1])
            if n < 2:
                break
            self.merges.append((int(best[0]), int(best[1])))
            seqs = [self._merge_once(s, best, next_id) for s in seqs]
            if verbose and (next_id - self.base) % 64 == 0:
                print(f"bpe: {next_id - self.base} merges, top pair count {n}")
            next_id += 1
        return self

    @staticmethod
    def _merge_once(seq: list[int], pair: tuple[int, int], new_id: int) -> list[int]:
        out = []
        i = 0
        while i < len(seq):
            if i + 1 < len(seq) and (seq[i], seq[i + 1]) == pair:
                out.append(new_id)
                i += 2
            else:
                out.append(seq[i])
                i += 1
        return out

    def _bpe_encode(self, symbols: list[int]) -> list[int]:
        seq = list(symbols)
        for rank, pair in enumerate(self.merges):
            seq = self._merge_once(seq, pair, self.base + rank)
        return seq

    def _bpe_decode(self, ids: list[int]) -> list[int]:
        table = {self.base + r: pair for r, pair in enumerate(self.merges)}

        def expand(tok: int) -> list[int]:
            if tok < self.base:
                return [tok]
            if tok not in table:  # malformed/out-of-vocab generation
                return []
            a, b = table[tok]
            return expand(a) + expand(b)

        out: list[int] = []
        for t in ids:
            out.extend(expand(t))
        return out

    # -- public API ----------------------------------------------------------

    def encode(self, actions: np.ndarray) -> list[int]:
        """[H, D] normalized actions -> variable-length token ids
        (0 <= id < max_token)."""
        return self._bpe_encode(list(self._quantize(actions)))

    def decode(self, ids, horizon: int, dim: int) -> np.ndarray:
        """token ids -> [H, D] actions. Truncates/pads the symbol stream to
        horizon*dim (robust to malformed generations)."""
        symbols = np.asarray(self._bpe_decode(list(int(i) for i in ids)))
        need = horizon * dim
        if symbols.size < need:
            symbols = np.pad(symbols, (0, need - symbols.size),
                             constant_values=self.coef_range)  # zero coef
        return self._dequantize(symbols[:need], horizon, dim)

    def encode_batch(self, actions: np.ndarray, max_len: int,
                     vocab_size: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """[B, H, D] -> (ids [B, max_len] int32, mask [B, max_len] bool).
        vocab_size maps tokens to the TAIL of the model vocabulary
        (id -> vocab_size - 1 - id), matching the binning convention."""
        b = len(actions)
        out = np.zeros((b, max_len), np.int32)
        mask = np.zeros((b, max_len), bool)
        for i, a in enumerate(np.asarray(actions)):
            ids = self.encode(a)[:max_len]
            if vocab_size is not None:
                ids = [vocab_size - 1 - t for t in ids]
            out[i, : len(ids)] = ids
            mask[i, : len(ids)] = True
        return out, mask

    def decode_batch(self, ids: np.ndarray, mask: np.ndarray, horizon: int,
                     dim: int, vocab_size: int | None = None) -> np.ndarray:
        out = np.zeros((len(ids), horizon, dim), np.float32)
        for i, (row, m) in enumerate(zip(np.asarray(ids), np.asarray(mask))):
            toks = [int(t) for t in row[m]]
            if vocab_size is not None:
                toks = [vocab_size - 1 - t for t in toks]
            toks = [t for t in toks if 0 <= t < self.max_token]
            out[i] = self.decode(toks, horizon, dim)
        return out

    # -- persistence ----------------------------------------------------------

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps({
            "scale": self.scale, "max_token": self.max_token,
            "coef_range": self.coef_range, "merges": self.merges,
        }))

    @classmethod
    def load(cls, path: str | Path) -> "FastTokenizer":
        d = json.loads(Path(path).read_text())
        tok = cls(scale=d["scale"], max_token=d["max_token"],
                  coef_range=d["coef_range"])
        tok.merges = [tuple(m) for m in d["merges"]]
        return tok
