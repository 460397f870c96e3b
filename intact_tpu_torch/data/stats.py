"""Dataset statistics: compute over trajectories, cache by content hash
(intact_tpu/data/stats.py with a cache directory of the port's own).

The schema is `config/dataset/bridge_statistics.json`'s: action/proprio mean,
std, max, min, p99, p01, and the transition and trajectory counts. The cache
file is named by a hash of the dataset's identity, as the JAX package names
it; `INTACT_STATS_CACHE` overrides the directory, which defaults to
~/.cache/intact_tpu_torch so the two packages never share a cache file.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np


def compute_statistics(trajectories) -> dict:
    """trajectories: iterable of dicts with "action" [T, D] and optional
    "proprio" [T, D]."""
    actions, proprios = [], []
    n_traj = 0
    for traj in trajectories:
        n_traj += 1
        a = np.asarray(traj["action"], np.float32)
        actions.append(a.reshape(-1, a.shape[-1]))
        if traj.get("proprio") is not None:
            p = np.asarray(traj["proprio"], np.float32)
            proprios.append(p.reshape(-1, p.shape[-1]))
    acts = np.concatenate(actions, axis=0)
    out = {"action": _field_stats(acts), "num_transitions": int(acts.shape[0]), "num_trajectories": n_traj}
    if proprios:
        out["proprio"] = _field_stats(np.concatenate(proprios, axis=0))
    return out


def _field_stats(x: np.ndarray) -> dict:
    return {
        "mean": x.mean(0).tolist(),
        "std": x.std(0).tolist(),
        "max": x.max(0).tolist(),
        "min": x.min(0).tolist(),
        "p99": np.quantile(x, 0.99, axis=0).tolist(),
        "p01": np.quantile(x, 0.01, axis=0).tolist(),
    }


def statistics_cache_path(unique_hash_inputs: list[str], cache_dir: str | None = None) -> Path:
    # NUL-joined so boundary shifts between inputs cannot collide
    h = hashlib.sha256("\x00".join(unique_hash_inputs).encode()).hexdigest()[:16]
    base = Path(cache_dir or os.environ.get("INTACT_STATS_CACHE", os.path.expanduser("~/.cache/intact_tpu_torch")))
    return base / f"dataset_statistics_{h}.json"


def get_dataset_statistics(trajectories_fn, hash_inputs: list[str], cache_dir=None) -> dict:
    """Load from the cache, or compute (calling trajectories_fn) and cache."""
    path = statistics_cache_path(hash_inputs, cache_dir)
    if path.exists():
        with open(path) as f:
            return json.load(f)
    stats = compute_statistics(trajectories_fn())
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(stats, f, indent=2)
    os.replace(tmp, path)  # a concurrent reader never sees half a file
    return stats


def load_statistics(path: str | Path) -> dict:
    with open(path) as f:
        return json.load(f)
