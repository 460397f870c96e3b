"""Dataset facade: config -> batched numpy iterator (intact_tpu/data/dataset.py).

Backends: "rlds" (the port's TFRecord/RLDS pipeline, `data/rlds.py`, which
needs no TensorFlow), "synthetic" (generated bridge-like episodes), and
"auto", which is "rlds" when the section's data_path exists and "synthetic"
otherwise. Synthetic batches are normalized here with the given statistics
("normal": mean/std, else p01/p99 bounds; the gripper, the last action dim,
is left alone); the RLDS pipeline normalizes with per-dataset statistics.
Per-host sharding: shard i of n sees episodes i, i+n, ...
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from intact_tpu_torch.data import normalize as nz
from intact_tpu_torch.data.synthetic import SyntheticBridgeDataset


class InterleavedDataset:
    def __init__(
        self,
        data_cfg,  # config.pipeline.DataConfig
        batch_size: int,
        split: str = "train",
        shard_index: int = 0,
        num_shards: int = 1,
        stats: dict | None = None,
        normalization_type: str = "normal",
        seed: int = 0,
        image_size: int = 224,
        task_paraphrase: bool = False,
    ):
        self.batch_size = batch_size
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.stats = stats
        self.normalization_type = normalization_type

        # paraphrase augmentation (train only; rephrase_prob 0.5 as the reference wires it)
        self.rephraser = None
        if task_paraphrase and split == "train":
            from intact_tpu_torch.data.task_augmentation import Rephraser

            table = getattr(data_cfg, "paraphrase_json", None)
            if table:
                self.rephraser = Rephraser(table, rephrase_prob=0.5, seed=seed)
            else:
                try:
                    self.rephraser = Rephraser.from_hub(rephrase_prob=0.5, seed=seed)
                except Exception as e:
                    raise RuntimeError(
                        "task_paraphrase=True but no paraphrase table: set data.paraphrase_json to a local JSON "
                        "or make the HF hub reachable (rail-berkeley/OXE_paraphrases)") from e

        section = data_cfg.train if split == "train" else data_cfg.val
        backend = getattr(data_cfg, "backend", "auto")
        if backend == "auto":
            path = getattr(section, "data_path", None)
            backend = "rlds" if path is not None and Path(path).exists() else "synthetic"
        self.backend = backend
        self.loader_stats = None
        if backend == "synthetic":
            self._ds = SyntheticBridgeDataset(
                image_size=image_size,
                window_size=section.window_size or 1,
                action_horizon=section.action_horizon or 1,
                seed=seed if split == "train" else seed + 10_000,
            )
            self._num_transitions = 2_195_527  # bridge-scale bookkeeping
        elif backend == "rlds":
            from intact_tpu_torch.data.rlds import RLDSInterleavedBackend

            self._ds = RLDSInterleavedBackend(
                data_cfg, section, split=split, seed=seed, shard_index=shard_index, num_shards=num_shards,
                image_size=image_size, rephraser=self.rephraser, normalization_type=normalization_type)
            self._num_transitions = self._ds.num_transitions
            self.loader_stats = self._ds.loader_stats
        else:
            raise ValueError(f"unknown data backend {backend!r}")

        # action normalization mask: every dim except the gripper (last)
        self._action_mask = None
        if stats is not None and "action" in stats:
            dim = len(stats["action"]["mean"])
            self._action_mask = np.array([True] * (dim - 1) + [False])

    def __len__(self) -> int:
        return self._num_transitions

    def __iter__(self) -> Iterator[dict]:
        if self.backend == "rlds":
            yield from self._ds.batches(self.batch_size)
            return
        # synthetic frames are raw: normalize here
        for batch in self._ds.batches(self.batch_size, self.shard_index, self.num_shards):
            batch = self._normalize(batch)
            if self.rephraser is not None:
                batch["task"] = dict(batch["task"])
                batch["task"]["language_instruction"] = self.rephraser.rephrase_batch(
                    batch["task"]["language_instruction"])
            yield batch

    def _normalize(self, batch: dict) -> dict:
        if self.stats is None:
            return batch
        out = dict(batch)
        obs = dict(batch["observation"])
        if self.normalization_type == "normal":
            out["action"] = nz.normalize_normal(
                batch["action"], np.asarray(self.stats["action"]["mean"]),
                np.asarray(self.stats["action"]["std"]), self._action_mask,
            )
            if "proprio" in obs and "proprio" in self.stats:
                obs["proprio"] = nz.normalize_normal(
                    obs["proprio"], np.asarray(self.stats["proprio"]["mean"]),
                    np.asarray(self.stats["proprio"]["std"]),
                )
        else:
            out["action"] = nz.normalize_bounds(
                batch["action"], np.asarray(self.stats["action"]["p01"]),
                np.asarray(self.stats["action"]["p99"]), self._action_mask,
            )
            if "proprio" in obs and "proprio" in self.stats:
                obs["proprio"] = nz.normalize_bounds(
                    obs["proprio"], np.asarray(self.stats["proprio"]["p01"]),
                    np.asarray(self.stats["proprio"]["p99"]),
                )
        out["observation"] = obs
        return out
