"""Dataset facade: config -> batched numpy iterator (intact_tpu/data/dataset.py
with the synthetic backend only).

`backend` "auto" resolves to "synthetic" (the RLDS backend is not ported, so
there is nothing else to find); "rlds" raises. Batches are normalized with
the given statistics ("normal": mean/std, else p01/p99 bounds; the gripper,
the last action dim, is left alone). Per-host sharding: shard i of n sees
episodes i, i+n, ...
"""

from __future__ import annotations

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
    ):
        self.batch_size = batch_size
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.stats = stats
        self.normalization_type = normalization_type

        backend = getattr(data_cfg, "backend", "auto")
        if backend == "rlds":
            raise NotImplementedError("the RLDS data backend is not ported yet; use backend 'synthetic'")
        if backend not in ("auto", "synthetic"):
            raise ValueError(f"unknown data backend {backend!r}")
        self.backend = "synthetic"
        section = data_cfg.train if split == "train" else data_cfg.val
        self._ds = SyntheticBridgeDataset(
            image_size=image_size,
            window_size=section.window_size or 1,
            action_horizon=section.action_horizon or 1,
            seed=seed if split == "train" else seed + 10_000,
        )
        self._num_transitions = 2_195_527  # bridge-scale bookkeeping

        # action normalization mask: every dim except the gripper (last)
        self._action_mask = None
        if stats is not None and "action" in stats:
            dim = len(stats["action"]["mean"])
            self._action_mask = np.array([True] * (dim - 1) + [False])

    def __len__(self) -> int:
        return self._num_transitions

    def __iter__(self) -> Iterator[dict]:
        for batch in self._ds.batches(self.batch_size, self.shard_index, self.num_shards):
            yield self._normalize(batch)

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
