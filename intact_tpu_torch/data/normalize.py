"""Action/proprio normalization and its inverse, from
intact_tpu/data/normalize.py (reference `src/data/utils/data_utils.py:250-302`
and env-adapter math `env_adapters/base.py:8-49`).

Two schemes:
  normal  (x - mean) / (std + eps)
  bounds  2 * (x - p01) / (p99 - p01 + eps) - 1, clipped to [-1, 1]

A boolean mask selects which dims to normalize — the gripper dim is skipped
for actions (`oxe/__init__.py:40-63` action_normalization_mask semantics).
All pure numpy.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-8


def normalize_normal(x, mean, std, mask=None):
    x = np.asarray(x, np.float32)
    out = (x - mean) / (np.asarray(std) + EPS)
    if mask is not None:
        out = np.where(mask, out, x)
    return out.astype(np.float32)


def denormalize_normal(x, mean, std, mask=None):
    x = np.asarray(x, np.float32)
    out = x * (np.asarray(std) + EPS) + mean
    if mask is not None:
        out = np.where(mask, out, x)
    return out.astype(np.float32)


def normalize_bounds(x, low, high, mask=None, clip=(-1.0, 1.0)):
    x = np.asarray(x, np.float32)
    out = 2.0 * (x - low) / (np.asarray(high) - np.asarray(low) + EPS) - 1.0
    out = np.clip(out, *clip)
    if mask is not None:
        out = np.where(mask, out, x)
    return out.astype(np.float32)


def denormalize_bounds(x, low, high, mask=None, clip=(-1.0, 1.0)):
    x = np.asarray(x, np.float32)
    clip_min, clip_max = clip
    out = (x - clip_min) / (clip_max - clip_min) * (np.asarray(high) - np.asarray(low)) + low
    if mask is not None:
        out = np.where(mask, out, x)
    return out.astype(np.float32)
