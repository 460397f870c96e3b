"""Language tokenization for VLA prompts.

The reference tokenizes with the HF PaliGemma tokenizer
(`modeling_mvla.py:388-407`: pad to tokenizer_max_length, append "\\n").
This module provides the same interface with three backends:

  * HFTokenizer — wraps a local HF fast tokenizer (tokenizer.json on disk or
    a cached hub snapshot). Required for checkpoint parity with released
    Pi0 weights.
  * HashTokenizer — dependency-free deterministic fallback (stable word ->
    id hashing) so training/serving/benchmarks run hermetically where no
    tokenizer asset exists. NOT vocabulary-compatible with PaliGemma.

Both return (tokens int32 [B, L], masks bool [B, L]).
"""

from __future__ import annotations

import hashlib
import logging
import os

import numpy as np

log = logging.getLogger("intact_tpu_torch.tokenizer")


class HashTokenizer:
    """Deterministic whitespace+hash tokenizer (test/bench backend)."""

    def __init__(self, vocab_size: int = 257_152, max_length: int = 72):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos_id = 2
        self.pad_id = 0

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        return 3 + h % (self.vocab_size - 3)

    def __call__(self, texts: list[str], max_length: int | None = None):
        L = max_length or self.max_length
        tokens = np.zeros((len(texts), L), np.int32)
        masks = np.zeros((len(texts), L), bool)
        for i, text in enumerate(texts):
            # match the reference prompt shape: bos + words + newline suffix
            ids = [self.bos_id] + [self._word_id(w) for w in f"{text}\n".split()]
            ids = ids[:L]
            tokens[i, : len(ids)] = ids
            masks[i, : len(ids)] = True
        return tokens, masks


class HFTokenizer:
    """PaliGemma tokenizer via transformers (needs a local asset: nothing is
    downloaded)."""

    def __init__(self, path_or_repo: str, max_length: int = 72):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path_or_repo, local_files_only=True)
        self.max_length = max_length

    def __call__(self, texts: list[str], max_length: int | None = None):
        L = max_length or self.max_length
        # reference appends "\n" to the instruction before tokenizing
        out = self.tok(
            [f"{t}\n" for t in texts],
            padding="max_length",
            truncation=True,
            max_length=L,
            return_tensors="np",
        )
        return out["input_ids"].astype(np.int32), out["attention_mask"].astype(bool)


def make_tokenizer(path_or_repo: str | None, max_length: int = 72,
                   vocab_size: int = 257_152):
    """Tokenizer factory with loud failure semantics.

    * ``path_or_repo`` set (config ``tokenizer_path`` / model-JSON field):
      load the HF tokenizer; a load failure RAISES — never a silent hash
      fallback, because a vocab mismatch corrupts language conditioning
      invisibly (reference tokenizes with the real PaliGemma tokenizer,
      `modeling_mvla.py:388-407`).
    * ``path_or_repo == "hash"``: explicit hermetic HashTokenizer.
    * ``path_or_repo is None``: honor $VLA_TOKENIZER_PATH if set (raises on
      failure), else HashTokenizer with a one-time warning.

    vocab_size bounds the hash fallback's ids to the model's embedding table.
    """
    if path_or_repo == "hash":
        return HashTokenizer(vocab_size=vocab_size, max_length=max_length)
    if not path_or_repo:
        path_or_repo = os.environ.get("VLA_TOKENIZER_PATH") or None
    if path_or_repo:
        try:
            return HFTokenizer(path_or_repo, max_length)
        except Exception as e:
            raise RuntimeError(
                f"failed to load HF tokenizer from {path_or_repo!r}; refusing "
                "to fall back to the hash tokenizer (vocab-incompatible with "
                "PaliGemma). Pass tokenizer_path='hash' to opt into the "
                "hermetic fallback explicitly."
            ) from e
    if not _warned_hash_fallback[0]:
        _warned_hash_fallback[0] = True
        log.warning(
            "no tokenizer asset configured (tokenizer_path / "
            "$VLA_TOKENIZER_PATH unset) — using the hermetic HashTokenizer. "
            "This is NOT PaliGemma-vocab-compatible; converted released "
            "checkpoints will see wrong language conditioning."
        )
    return HashTokenizer(vocab_size=vocab_size, max_length=max_length)


_warned_hash_fallback = [False]
