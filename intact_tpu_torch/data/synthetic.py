"""Synthetic bridge-like episode generator (a copy of intact_tpu/data/synthetic.py).

Serves the role the reference's test scripts fill by iterating real RLDS
data (`scripts/dataset/test_rlds_dataset.py`) but hermetically: smooth
random end-effector trajectories with a settling gripper, small rendered
"scenes" (colored blobs) as camera frames, and instructions drawn from a
fixed bank. Deterministic per (seed, episode index).

Frames follow the RLDS batch schema (see data/__init__.py) so the trainer
and tests exercise exactly the real pipeline surface.
"""

from __future__ import annotations

import numpy as np

from intact_tpu_torch.data.transforms import chunk_act_obs

INSTRUCTIONS = [
    "put the carrot on the plate",
    "put eggplant in basket",
    "put the spoon on the towel",
    "stack the green cube on the yellow cube",
    "move the red object to the left",
    "pick up the blue cup",
    "open the drawer",
    "close the microwave door",
]


class SyntheticBridgeDataset:
    def __init__(
        self,
        image_size: int = 224,
        action_dim: int = 7,
        proprio_dim: int = 7,
        min_len: int = 20,
        max_len: int = 40,
        window_size: int = 1,
        action_horizon: int = 4,
        seed: int = 0,
        num_episodes: int = 1_000_000,
    ):
        self.image_size = image_size
        self.action_dim = action_dim
        self.proprio_dim = proprio_dim
        self.min_len = min_len
        self.max_len = max_len
        self.window_size = window_size
        self.action_horizon = action_horizon
        self.seed = seed
        self.num_episodes = num_episodes

    def episode(self, idx: int) -> dict:
        """One chunked trajectory dict."""
        return chunk_act_obs(self.raw_episode(idx), self.window_size, self.action_horizon)

    def raw_episode(self, idx: int) -> dict:
        """One unchunked trajectory in the canonical layout."""
        rng = np.random.default_rng((self.seed, idx))
        T = int(rng.integers(self.min_len, self.max_len + 1))
        s = self.image_size

        # smooth xyz-rpy deltas: low-pass filtered noise
        raw = rng.normal(0, 0.02, size=(T + 8, self.action_dim - 1))
        kernel = np.ones(8) / 8
        smooth = np.stack([np.convolve(raw[:, d], kernel, "valid")[:T]
                           for d in range(self.action_dim - 1)], axis=1)
        gripper = (np.arange(T) > T // 2).astype(np.float32)[:, None]  # closes mid-episode
        action = np.concatenate([smooth, gripper], axis=1).astype(np.float32)

        proprio = np.cumsum(action, axis=0).astype(np.float32)[:, : self.proprio_dim]

        # cheap "scene": two colored rectangles whose position tracks proprio
        imgs = np.zeros((T, s, s, 3), np.uint8)
        base = rng.integers(40, 200, size=3, dtype=np.int64)
        imgs[:] = base[None, None, None, :]
        cx = (s // 2 + proprio[:, 0] * s * 2).astype(int) % (s - 24)
        cy = (s // 2 + proprio[:, 1] * s * 2).astype(int) % (s - 24)
        color = rng.integers(0, 255, size=3)
        for t in range(T):
            imgs[t, cy[t]:cy[t] + 24, cx[t]:cx[t] + 24] = color

        instruction = INSTRUCTIONS[int(rng.integers(len(INSTRUCTIONS)))]
        return {
            "observation": {"image_primary": imgs, "proprio": proprio},
            "task": {"language_instruction": np.array([instruction.encode()] * T)},
            "action": action,
            "action_pad_mask": np.ones((T, self.action_dim), bool),
        }

    def frames(self):
        """Infinite stream of per-timestep frames across episodes."""
        return self._sharded_frames(0, 1)

    def batches(self, batch_size: int, shard_index: int = 0, num_shards: int = 1):
        """Infinite batched stream with per-host sharding (each shard sees a
        disjoint episode subsequence — the per-rank sharding the reference
        pipeline lacked, SURVEY.md §3.5 note)."""
        it = self._sharded_frames(shard_index, num_shards)
        while True:
            frames = [next(it) for _ in range(batch_size)]
            yield _stack_frames(frames)

    def _sharded_frames(self, shard_index: int, num_shards: int):
        ep = shard_index
        while True:
            traj = self.episode(ep % self.num_episodes)
            T = len(traj["action"])
            lang = traj["task"]["language_instruction"]
            for t in range(T):
                yield {
                    "observation": {
                        "image_primary": traj["observation"]["image_primary"][t],
                        "proprio": traj["observation"]["proprio"][t],
                        "timestep_pad_mask": traj["observation"]["timestep_pad_mask"][t],
                    },
                    "task": {"language_instruction": lang[t]},
                    "action": traj["action"][t],
                    "action_pad_mask": traj["action_pad_mask"][t],
                }
            ep += num_shards


def _stack_frames(frames: list[dict]) -> dict:
    def stack(key_fn):
        return np.stack([key_fn(f) for f in frames])

    return {
        "observation": {
            "image_primary": stack(lambda f: f["observation"]["image_primary"]),
            "proprio": stack(lambda f: f["observation"]["proprio"]),
            "timestep_pad_mask": stack(lambda f: f["observation"]["timestep_pad_mask"]),
        },
        "task": {"language_instruction": np.array([f["task"]["language_instruction"] for f in frames])},
        "action": stack(lambda f: f["action"]),
        "action_pad_mask": stack(lambda f: f["action_pad_mask"]),
    }
