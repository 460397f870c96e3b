"""Language-logic-chain probing: sticky per-episode word substitutions (a copy
of intact_tpu/envs/adapters/language_mapper.py).

Reference `src/experiments/env_adapters/language_mapper.py:4-23`: map object
words to descriptive paraphrases ("carrot" -> "the orange vegetable that
rabbits like"), chosen once per episode (seeded) and held fixed so the
policy sees a consistent re-description within an episode.
"""

from __future__ import annotations

import random

DEFAULT_CANDIDATES: dict[str, list[str]] = {
    "carrot": [
        "the orange vegetable that rabbits like",
        "the long orange root vegetable",
    ],
    "eggplant": [
        "the purple vegetable",
        "the shiny purple oblong vegetable",
    ],
    "spoon": [
        "the metal utensil for soup",
        "the small scooping utensil",
    ],
    "cube": [
        "the small block",
        "the box-shaped object",
    ],
}


class PersistentLanguageMapper:
    def __init__(self, candidates: dict[str, list[str]] | None = None, seed: int = 0):
        self.candidates = candidates or DEFAULT_CANDIDATES
        self.seed = seed
        self._episode = 0
        self._mapping: dict[str, str] = {}
        self.reset()

    def reset(self, episode: int | None = None) -> None:
        """Re-draw the sticky mapping for a new episode."""
        self._episode = self._episode + 1 if episode is None else episode
        rng = random.Random(f"{self.seed}:{self._episode}")
        self._mapping = {
            word: rng.choice(options) for word, options in self.candidates.items()
        }

    def map(self, instruction: str) -> str:
        out = instruction
        for word, replacement in self._mapping.items():
            if word in out:
                out = out.replace(word, replacement)
        return out
