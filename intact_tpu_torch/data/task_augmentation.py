"""Task (language) augmentation: instruction paraphrasing
(intact_tpu/data/task_augmentation.py without TensorFlow).

A paraphrase table maps instructions to rephrasings. Per trajectory one coin
(probability `rephrase_prob`) decides whether its frames are rephrased; a
rephrased trajectory draws, for every frame, one of the original instruction
and its paraphrases. The table loads from a local JSON; `from_hub` keeps the
reference's hub corpus loader, which needs the hub (nothing is downloaded
where there is none). `delete_task_conditioning` blanks instructions for
goal-image-only training.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class Rephraser:
    def __init__(self, table: dict[str, list[str]] | str | Path, rephrase_prob: float = 0.5, seed: int = 0):
        if isinstance(table, (str, Path)):
            with open(table) as f:
                table = json.load(f)
        self.table = {k: list(v) for k, v in table.items()}
        self.rephrase_prob = rephrase_prob
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_hub(cls, repo_id: str = "rail-berkeley/OXE_paraphrases", **kw):
        """Load the upstream paraphrase corpus (needs network + hub)."""
        import pickle

        from huggingface_hub import hf_hub_download

        path = hf_hub_download(repo_id=repo_id, filename="paraphrases_oxe.pkl", repo_type="dataset")
        with open(path, "rb") as f:
            raw = pickle.load(f)
        return cls(raw, **kw)

    def rephrase(self, instruction: str) -> str:
        """One frame: a random paraphrase with probability rephrase_prob."""
        options = self.table.get(instruction)
        if not options or self._rng.uniform() >= self.rephrase_prob:
            return instruction
        return options[int(self._rng.integers(len(options)))]

    def rephrase_batch(self, instructions) -> np.ndarray:
        out = []
        for s in instructions:
            text = s.decode() if isinstance(s, bytes) else str(s)
            out.append(self.rephrase(text).encode())
        return np.asarray(out)

    def rephrase_trajectory(self, instructions: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """A trajectory's [T] instruction bytes -> rephrased [T]: with
        probability rephrase_prob each frame takes one of (original,
        *paraphrases); otherwise, or without a table entry, unchanged."""
        if len(instructions) == 0:
            return instructions
        first = instructions[0]
        options = self.table.get(first.decode() if isinstance(first, bytes) else str(first))
        if not options:
            return instructions
        choices = [first] + [o.encode() for o in options]
        idx = rng.integers(0, len(choices), size=len(instructions))
        if not rng.random() < self.rephrase_prob:
            return instructions
        out = np.empty(len(instructions), object)
        out[:] = [choices[i] for i in idx]
        return out


def delete_task_conditioning(instructions, keep_prob: float, rng: np.random.Generator):
    """Blank instructions with prob 1 - keep_prob (goal-image training mode)."""
    keep = rng.uniform(size=len(instructions)) < keep_prob
    return np.asarray([s if k else (b"" if isinstance(s, bytes) else "") for s, k in zip(instructions, keep)])
