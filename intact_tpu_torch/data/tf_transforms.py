"""The RLDS path's trajectory and frame transforms (intact_tpu/data/tf_transforms.py
in numpy, over the port's codec; the module keeps its name so the two are
found side by side).

Gripper relabeling, chunking (`transforms.chunk_act_obs`, whose semantics are
the JAX package's `chunk_act_obs_tf`'s), uniform goal relabeling, whole-frame
image dropout, and the frame decode / resize / augment entry points. Random
draws come from explicit `numpy.random.Generator`s: the streams are the port's
own, not TensorFlow's stateless ones.
"""

from __future__ import annotations

import numpy as np

from intact_tpu_torch.data import codec
from intact_tpu_torch.data.transforms import chunk_act_obs

__all__ = [
    "tree_map", "binarize_gripper_actions", "invert_gripper_actions", "rel2abs_gripper_actions", "chunk_act_obs",
    "uniform_goal_relabel", "apply_goal_relabel", "decode_and_resize", "decode_augment_resize",
    "image_dropout", "padding_image",
]


def tree_map(fn, tree):
    """fn over the leaves of a nested dict (tf.nest.map_structure's role)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# gripper relabeling
# ---------------------------------------------------------------------------

def binarize_gripper_actions(actions, open_thresh=0.95, close_thresh=0.05) -> np.ndarray:
    """Continuous [0, 1] -> binary, resolving intermediate values by scanning
    backward to the next decisive command (starting from open)."""
    actions = np.asarray(actions, np.float32)
    out = np.empty_like(actions)
    carried = np.float32(1.0)
    for i in range(len(actions) - 1, -1, -1):
        if actions[i] > open_thresh:
            carried = np.float32(1.0)
        elif actions[i] < close_thresh:
            carried = np.float32(0.0)
        out[i] = carried
    return out


def invert_gripper_actions(actions) -> np.ndarray:
    return np.float32(1.0) - np.asarray(actions, np.float32)


def rel2abs_gripper_actions(actions) -> np.ndarray:
    """Relative (+1 open / -1 close / 0 hold) -> absolute [0, 1] (1 = open):
    the last command carries through holds; leading holds take the first
    command (open when there is none)."""
    actions = np.asarray(actions, np.float32)
    command = (actions > 0.5).astype(np.float32) - (actions < -0.5).astype(np.float32)
    carried = np.empty(len(command), np.float32)
    state = np.float32(0.0)
    for i, c in enumerate(command):
        if c != 0.0:
            state = c
        carried[i] = state
    known = carried[carried != 0.0]
    carried[carried == 0.0] = known[0] if known.size else np.float32(1.0)
    return (carried + np.float32(1.0)) / np.float32(2.0)


# ---------------------------------------------------------------------------
# goal relabeling (trajectory level, before chunking)
# ---------------------------------------------------------------------------

def apply_goal_relabel(traj: dict, goal_idxs: np.ndarray, reached: np.ndarray) -> dict:
    """Adds task/goal_<image key> (the goal frames), task/timestep and a
    per-frame reward (0 where reached, else -1)."""
    goal_idxs = np.asarray(goal_idxs, np.int32)
    task = dict(traj.get("task", {}))
    for key, value in traj["observation"].items():
        if key.startswith("image_"):
            task["goal_" + key] = np.asarray(value)[goal_idxs]
    task["timestep"] = goal_idxs
    traj["task"] = task
    traj["reward"] = np.where(reached, np.float32(0.0), np.float32(-1.0))
    return traj


def uniform_goal_relabel(traj: dict, reached_proportion: float, rng: np.random.Generator) -> dict:
    """Uniform future-state goal relabeling: with probability
    reached_proportion frame i's goal is frame i (reward 0), else a frame drawn
    uniformly from i+1.. (reward -1); the final frame always reaches its goal."""
    n = len(traj["action"])
    rand = rng.random(n, dtype=np.float32)
    low = np.arange(n, dtype=np.float32) + np.float32(1)
    goal = np.minimum((rand * (np.float32(n) - low) + low).astype(np.int32), n - 1)
    reached = (rng.random(n, dtype=np.float32) < reached_proportion) | (np.arange(n) == n - 1)
    return apply_goal_relabel(traj, np.where(reached, np.arange(n, dtype=np.int32), goal), reached)


# ---------------------------------------------------------------------------
# frame-level image ops
# ---------------------------------------------------------------------------

def padding_image(size: tuple[int, int]) -> np.ndarray:
    """The zero frame of a missing camera."""
    return np.zeros((size[0], size[1], 3), np.uint8)


def _is_padding(image) -> bool:
    return isinstance(image, (bytes, bytearray, memoryview)) and len(image) == 0


def decode_and_resize(image, size: tuple[int, int]) -> np.ndarray:
    """Encoded bytes or uint8 [H, W, 3] -> uint8 [size, 3] (lanczos3 where the
    size differs). An empty byte string is a padding camera: zeros."""
    if _is_padding(image):
        return padding_image(size)
    if isinstance(image, (bytes, bytearray, memoryview)):
        image = codec.decode_image(image)
    image = np.asarray(image, np.uint8)
    if image.shape[:2] != tuple(size):
        image = codec.resize_lanczos3(image, size)
    return image


def decode_augment_resize(image, size: tuple[int, int], draws: codec.JitterDraws) -> np.ndarray:
    """The train path's fused frame transform: decode, random-resized crop of
    the SOURCE frame resized once to `size`, colour jitter. Padding cameras
    stay zero (jitter would turn them grey)."""
    if _is_padding(image):
        return padding_image(size)
    if isinstance(image, (bytes, bytearray, memoryview)):
        image = codec.decode_image(image)
    return codec.crop_resize_jitter(image, size, draws)


def image_dropout(image: np.ndarray, rng: np.random.Generator, dropout_prob: float) -> np.ndarray:
    """Zero a whole camera frame (all its history) with probability dropout_prob."""
    return np.zeros_like(image) if rng.random() < dropout_prob else image
