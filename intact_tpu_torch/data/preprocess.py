"""Offline RLDS dataset modification: resize, re-encode, proprio conversion
(intact_tpu/data/preprocess.py over the port's reader, codec and writer).

Streams a TFDS-layout dataset through a chain of episode-level mod functions
on a thread pool and writes a new TFDS-layout dataset. Mod functions take
decoded numpy episode trees and are registered in RLDS_MOD_FUNCTIONS.
"""

from __future__ import annotations

import concurrent.futures
import functools
from collections import deque
from pathlib import Path
from typing import Callable, Iterator

import numpy as np

from intact_tpu_torch.data import codec


@functools.lru_cache(maxsize=1)
def _registry_cameras() -> frozenset[str]:
    from intact_tpu_torch.data.oxe.registry import OXE_DATASET_CONFIGS

    return frozenset(v for c in OXE_DATASET_CONFIGS.values() for v in c["image_keys"].values() if v)


def _is_image_key(key: str) -> bool:
    """Camera keys across OXE are named every which way (image_0, wrist_image,
    hand_image, cam_high, rgb_static, finger_vision_1, ...): match by pattern
    plus every raw key the registry maps as a camera."""
    if "image" in key or "rgb" in key or key.startswith("cam_"):
        return True
    return key in _registry_cameras()


def _decode_images(ep: dict) -> dict:
    """Encoded per-step byte strings -> uint8 [T, H, W, 3]."""
    obs = dict(ep.get("observation", {}))
    for key, val in obs.items():
        arr = np.asarray(val)
        if _is_image_key(key) and arr.dtype.kind in ("S", "O"):
            obs[key] = np.stack([codec.decode_image(f) for f in arr])
    out = dict(ep)
    out["observation"] = obs
    return out


def resize_images(ep: dict, size: int = 224) -> dict:
    """Resize every observation image to size x size (lanczos3; JPEG encoding
    happens in the writer with image_encoding='jpeg')."""
    obs = dict(ep["observation"])
    for key, val in obs.items():
        arr = np.asarray(val)
        if _is_image_key(key) and arr.dtype == np.uint8 and arr.ndim == 4 and arr.shape[1:3] != (size, size):
            obs[key] = np.stack([codec.resize_lanczos3(f, (size, size)) for f in arr])
    out = dict(ep)
    out["observation"] = obs
    return out


def proprio_quat_to_euler(ep: dict) -> dict:
    """proprio [T, 8] (xyz + xyzw quat + gripper) -> [T, 7] (xyz + rpy + gripper)."""
    from scipy.spatial.transform import Rotation

    obs = dict(ep["observation"])
    p = np.asarray(obs["proprio"], np.float32)
    if p.shape[-1] != 8:
        raise ValueError(f"expected 8-dim quat proprio, got {p.shape[-1]}")
    rpy = Rotation.from_quat(p[:, 3:7]).as_euler("xyz").astype(np.float32)
    obs["proprio"] = np.concatenate([p[:, :3], rpy, p[:, 7:8]], axis=-1)
    out = dict(ep)
    out["observation"] = obs
    return out


def proprio_euler_to_quat(ep: dict) -> dict:
    """proprio [T, 7] (xyz + rpy + gripper) -> [T, 8] (xyz + xyzw quat + gripper)."""
    from scipy.spatial.transform import Rotation

    obs = dict(ep["observation"])
    p = np.asarray(obs["proprio"], np.float32)
    if p.shape[-1] != 7:
        raise ValueError(f"expected 7-dim euler proprio, got {p.shape[-1]}")
    quat = Rotation.from_euler("xyz", p[:, 3:6]).as_quat().astype(np.float32)
    obs["proprio"] = np.concatenate([p[:, :3], quat, p[:, 6:7]], axis=-1)
    out = dict(ep)
    out["observation"] = obs
    return out


RLDS_MOD_FUNCTIONS: dict[str, Callable[[dict], dict]] = {
    "resize_and_jpeg_encode": resize_images,  # pair with image_encoding="jpeg"
    "resize": resize_images,
    "proprio_quat_to_euler": proprio_quat_to_euler,
    "proprio_euler_to_quat": proprio_euler_to_quat,
}


def modify_rlds_dataset(
    data_dir: str | Path,
    name: str,
    target_dir: str | Path,
    mods: list[str],
    *,
    split: str = "train",
    num_workers: int = 8,
    num_shards: int = 8,
    image_size: int = 224,
    image_encoding: str = "jpeg",
    limit: int | None = None,
) -> Path:
    """Stream-modify a dataset: read -> decode -> mods (thread pool) -> write
    new TFDS-layout shards. Returns the written dataset dir."""
    from intact_tpu_torch.data import tfrecord_rlds

    if Path(data_dir).resolve() == Path(target_dir).resolve():
        raise ValueError("target_dir must differ from data_dir (no overwrite)")
    for m in mods:
        if m not in RLDS_MOD_FUNCTIONS:
            raise KeyError(f"unknown mod {m!r}; available: {sorted(RLDS_MOD_FUNCTIONS)}")
    episodes = tfrecord_rlds.read_rlds_dataset(data_dir, name, split=split, shuffle_files=False)

    def process(ep: dict) -> dict:
        ep = _decode_images(ep)
        for m in mods:
            fn = RLDS_MOD_FUNCTIONS[m]
            ep = fn(ep, image_size) if m in ("resize", "resize_and_jpeg_encode") else fn(ep)
        return ep

    def stream() -> Iterator[dict]:
        # a bounded in-flight window: decode and resize release the GIL in the codec
        with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
            pending: deque = deque()
            for i, raw in enumerate(episodes):
                if limit is not None and i >= limit:
                    break
                pending.append(pool.submit(process, raw))
                if len(pending) >= num_workers * 2:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

    return tfrecord_rlds.write_rlds_dataset(target_dir, name, stream(), split=split, num_shards=num_shards,
                                            image_encoding=image_encoding)
