"""Text encoders for goal/language conditioning (intact_tpu/utils/text_processing.py).

Pluggable text -> (token ids | embeddings) processors. The hash tokenizer
keeps everything hermetic; the HF-backed variant loads only local assets.
"""

from __future__ import annotations

import numpy as np

from intact_tpu_torch.models.tokenizer import HashTokenizer, make_tokenizer


class TextProcessor:
    """Interface: encode(list[str]) -> dict of numpy arrays."""

    def encode(self, strings: list[str]) -> dict:
        raise NotImplementedError


class TokenProcessor(TextProcessor):
    """Tokenize to ids + mask."""

    def __init__(self, path_or_repo: str | None = None, max_length: int = 72, vocab_size: int = 257_152):
        self.tokenizer = make_tokenizer(path_or_repo, max_length, vocab_size)
        self.max_length = max_length

    def encode(self, strings: list[str]) -> dict:
        ids, mask = self.tokenizer(list(strings), self.max_length)
        return {"input_ids": ids, "attention_mask": mask.astype(np.int32)}


class HashEmbedding(TextProcessor):
    """Deterministic sentence embeddings via hashed bag-of-words (the hermetic
    stand-in for a learned sentence encoder)."""

    def __init__(self, dim: int = 512, seed: int = 0):
        self.dim = dim
        self._tok = HashTokenizer(vocab_size=1 << 16, max_length=32)
        rng = np.random.default_rng(seed)
        self._table = rng.normal(0, 1 / np.sqrt(dim), size=(1 << 16, dim)).astype(np.float32)

    def encode(self, strings: list[str]) -> dict:
        ids, mask = self._tok(list(strings))
        emb = self._table[ids % (1 << 16)] * mask[..., None]
        denom = np.maximum(mask.sum(-1, keepdims=True), 1)
        return {"embedding": (emb.sum(1) / denom).astype(np.float32)}


class HFTextEmbedding(TextProcessor):
    """Frozen HF text encoder (CLIP/T5-style) when the asset exists locally."""

    def __init__(self, model_name: str, max_length: int = 32):
        from transformers import AutoModel, AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(model_name)
        self.model = AutoModel.from_pretrained(model_name)
        self.max_length = max_length

    def encode(self, strings: list[str]) -> dict:
        import torch

        batch = self.tok(list(strings), padding="max_length", truncation=True, max_length=self.max_length,
                         return_tensors="pt")
        with torch.no_grad():
            out = self.model(**batch).last_hidden_state.mean(1)
        return {"embedding": out.numpy().astype(np.float32)}
