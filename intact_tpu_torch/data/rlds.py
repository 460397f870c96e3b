"""RLDS interleaved input pipeline on the host, without TensorFlow
(intact_tpu/data/rlds.py as Python iterators over a thread pool).

The stages and their order are the JAX package's:

  load (TFDS TFRecord shards or an .npz episode dir) -> standardize (oxe
  registry) -> statistics (full dataset, before any filter) -> unlabeled /
  max_action filters -> normalize (masked) -> repeat -> trajectory transforms
  (goal relabel, paraphrase, chunk, subsample) -> flatten to frames -> pad
  mixes to the mix maxima -> balanced weighted interleave -> shuffle buffer
  -> frame transforms (decode, resize or crop+jitter, dropout) -> batch

Everything up to the shuffle buffer runs in the consuming thread; the frame
transforms (the codec's decode and pixel loops, which release the GIL) run
on a thread pool in order. Random draws come from `numpy.random.Generator`s
keyed on (seed, index), so a run is reproducible whatever the threads do;
the streams are the port's own, not TensorFlow's. Seeds of the frame stage
are derived as the JAX package derives them: `seed_offset * 31 + j` for the
augment of camera j, `* 37 + j` for its dropout.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable, Iterator

import numpy as np

from intact_tpu_torch.data import codec
from intact_tpu_torch.data import stats as stats_lib
from intact_tpu_torch.data import tf_transforms as tft
from intact_tpu_torch.data import tfrecord_rlds

logger = logging.getLogger("intact_tpu_torch.rlds")


class LoaderStats:
    """Seconds spent per stage, summed over threads, and counts."""

    FIELDS = ("read_parse_s", "decode_s", "transform_s", "frames", "episodes", "errors")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            for f in self.FIELDS:
                setattr(self, f, 0)

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in self.FIELDS}


def _strings(values) -> np.ndarray:
    out = np.empty(len(values), object)
    out[:] = [v if isinstance(v, bytes) else str(v).encode() for v in values]
    return out


# ---------------------------------------------------------------------------
# episode sources
# ---------------------------------------------------------------------------

class _TimedEpisodes:
    """An episode iterable whose walks add their read+parse time to `stats`."""

    def __init__(self, episodes: Iterable[dict], stats: LoaderStats | None):
        self.episodes, self.stats = episodes, stats

    def __iter__(self) -> Iterator[dict]:
        it = iter(self.episodes)
        while True:
            t = time.perf_counter()
            try:
                ep = next(it)
            except StopIteration:
                return
            if self.stats is not None:
                self.stats.add(read_parse_s=time.perf_counter() - t, episodes=1)
            yield ep


def _episodes_from_tfds(name: str, data_dir: str, split: str, shuffle_files: bool = True):
    """TFDS-layout episodes through the port's TFRecord reader. There is no
    tensorflow_datasets fallback: a schema the reader cannot parse raises
    with a pointer to it."""
    try:
        return tfrecord_rlds.read_rlds_dataset(data_dir, name, split=split, shuffle_files=shuffle_files)
    except Exception as err:
        raise RuntimeError(
            f"the TFRecord reader failed for {name!r} under {data_dir!r} (split {split!r}). Fix the dataset "
            "layout or extend intact_tpu_torch/data/tfrecord_rlds.py for this schema (tensorflow_datasets is "
            "not used); alternatively convert the episodes to an .npz episode directory") from err


class _SkippingEpisodes:
    """Walks an RLDSEpisodes' shards; a corrupt record (bad framing or CRC)
    is logged and counted, and the rest of its shard skipped, where
    tf.data's ignore_errors would drop it."""

    def __init__(self, episodes: tfrecord_rlds.RLDSEpisodes, stats: LoaderStats | None):
        self.episodes, self.stats = episodes, stats

    def __iter__(self) -> Iterator[dict]:
        for path, skip, take in self.episodes.entries:
            try:
                for rec in tfrecord_rlds.iter_records(path, skip, take):
                    yield tfrecord_rlds.decode_episode(rec, self.episodes.spec)
            except tfrecord_rlds.RecordError as e:
                if self.stats is not None:
                    self.stats.add(errors=1)
                logger.warning("skipping the rest of a shard after a corrupt record: %s", e)


class _NpzEpisodes:
    """A directory of per-trajectory .npz files (image_primary, proprio,
    action, language_instruction), already standardized."""

    def __init__(self, files: list[str]):
        self.files = files

    def __iter__(self) -> Iterator[dict]:
        for fp in self.files:
            with np.load(fp, allow_pickle=False) as z:
                yield {
                    "observation": {"image_primary": z["image_primary"], "proprio": z["proprio"].astype(np.float32)},
                    "task": {"language_instruction": _strings(z["language_instruction"].astype("S"))},
                    "action": z["action"].astype(np.float32),
                }


def _npz_files(path: Path) -> list[str]:
    files = sorted(str(p) for p in Path(path).glob("*.npz"))
    if not files:
        raise FileNotFoundError(f"no .npz episodes under {path}")
    return files


class _Sharded:
    def __init__(self, items: Iterable, num_shards: int, shard_index: int):
        self.items, self.n, self.i = items, num_shards, shard_index

    def __iter__(self):
        for k, x in enumerate(self.items):
            if k % self.n == self.i:
                yield x


# ---------------------------------------------------------------------------
# per-dataset pipeline
# ---------------------------------------------------------------------------

class TrajectorySource:
    """One pass over a dataset's standardized, filtered, normalized
    trajectories; iterate again for the next epoch."""

    def __init__(self, episodes: Iterable[dict], standardize_fn: Callable | None, keep: Callable[[dict], bool],
                 normalize: Callable[[dict], dict]):
        self.episodes, self.standardize_fn, self.keep, self.normalize = episodes, standardize_fn, keep, normalize

    def __iter__(self) -> Iterator[dict]:
        for ep in self.episodes:
            traj = self.standardize_fn(ep) if self.standardize_fn is not None else ep
            if self.keep(traj):
                yield self.normalize(traj)


def _normalizer(statistics: dict, mask: np.ndarray, normalization_type: str) -> Callable[[dict], dict]:
    f = np.float32

    def consts(field, *keys):
        return [np.asarray(statistics[field][k], f) for k in keys]

    eps = f(1e-8)

    def scheme(x, field):
        if normalization_type == "normal":
            mean, std = consts(field, "mean", "std")
            return (x - mean) / (std + eps)
        lo, hi = consts(field, "p01", "p99")
        return np.clip(f(2.0) * (x - lo) / (hi - lo + eps) - f(1.0), f(-1.0), f(1.0))

    def normalize(traj: dict) -> dict:
        a = np.asarray(traj["action"], f)
        traj["action"] = np.where(mask, scheme(a, "action"), a).astype(f)
        obs = traj["observation"]
        if "proprio" in obs and "proprio" in statistics:
            obs["proprio"] = scheme(np.asarray(obs["proprio"], f), "proprio").astype(f)
        return traj

    return normalize


def make_dataset_from_rlds(
    name: str,
    data_dir: str,
    *,
    train: bool,
    standardize_fn=None,
    split: str | None = None,
    action_normalization_mask=None,
    normalization_type: str = "normal",
    dataset_statistics: dict | str | None = None,
    skip_unlabeled: bool = True,
    max_action: float | None = None,
    shard_index: int = 0,
    num_shards: int = 1,
    loader_stats: LoaderStats | None = None,
) -> tuple[TrajectorySource, dict]:
    """-> (trajectory source in the canonical layout, statistics dict)."""
    src = Path(data_dir) / name
    if src.exists() and any(src.rglob("dataset_info.json")):  # the TFDS layout
        split = split or ("train[:95%]" if train else "train[95%:]")
        episodes: Iterable[dict] = _SkippingEpisodes(_episodes_from_tfds(name, data_dir, split), loader_stats)

        def stats_source():
            for ep in _episodes_from_tfds(name, data_dir, "train", shuffle_files=False):
                yield standardize_fn(ep) if standardize_fn is not None else ep
    else:
        files = _npz_files(src)
        split_point = int(len(files) * 0.95)
        episodes = _NpzEpisodes(files[:split_point] if train else files[split_point:])
        standardize_fn = None  # npz episodes are standardized by the conversion tooling

        def stats_source():
            yield from _NpzEpisodes(_npz_files(src))
    if num_shards > 1:
        episodes = _Sharded(episodes, num_shards, shard_index)
    episodes = _TimedEpisodes(episodes, loader_stats)

    # statistics over the FULL dataset (never the host's shard or the
    # train/val slice), before the filters, as the JAX pipeline computes them
    if isinstance(dataset_statistics, (str, Path)):
        statistics = stats_lib.load_statistics(dataset_statistics)
    elif isinstance(dataset_statistics, dict):
        statistics = dataset_statistics
    else:
        def traj_iter():
            for t in stats_source():
                yield {"action": t["action"], "proprio": t["observation"].get("proprio")}

        statistics = stats_lib.get_dataset_statistics(traj_iter, [name, str(data_dir), "full"])

    def keep(traj: dict) -> bool:
        lang = traj.get("task", {}).get("language_instruction")
        if skip_unlabeled and not (lang is not None and any(len(s) > 0 for s in lang)):
            return False
        return max_action is None or bool(np.all(np.abs(traj["action"]) <= max_action))

    mask = np.asarray(action_normalization_mask if action_normalization_mask is not None
                      else [True] * len(statistics["action"]["mean"]))
    return TrajectorySource(episodes, standardize_fn, keep, _normalizer(statistics, mask, normalization_type)), \
        statistics


def apply_trajectory_transforms(
    trajectories: Iterable[dict],
    *,
    train: bool,
    window_size: int = 1,
    action_horizon: int = 1,
    max_action_future: int | None = None,
    goal_relabeling_strategy: str | None = None,
    goal_relabeling_kwargs: dict | None = None,
    rephraser=None,
    subsample_length: int | None = None,
    seed: int = 0,
) -> Iterator[dict]:
    """goal relabel -> paraphrase -> chunk -> subsample, each trajectory's
    draws keyed on (seed, its index in the stream)."""
    if goal_relabeling_strategy not in (None, "uniform"):
        raise ValueError(f"unknown goal_relabeling_strategy {goal_relabeling_strategy!r}")
    kwargs = goal_relabeling_kwargs or {"reached_proportion": 0.3}
    for i, traj in enumerate(trajectories):
        if goal_relabeling_strategy == "uniform":
            traj = tft.uniform_goal_relabel(traj, rng=np.random.default_rng([seed, i, 1]), **kwargs)
        if rephraser is not None and train and "language_instruction" in traj.get("task", {}):
            traj["task"] = dict(traj["task"])
            traj["task"]["language_instruction"] = rephraser.rephrase_trajectory(
                traj["task"]["language_instruction"], np.random.default_rng([seed, i, 2]))
        traj = tft.chunk_act_obs(traj, window_size, action_horizon, max_action_future)
        if train and subsample_length is not None:
            length = len(traj["action"])
            idx = np.random.default_rng([seed + 7919, i]).permutation(length)[:subsample_length]
            traj = tft.tree_map(lambda x: np.asarray(x)[idx], traj)
        yield traj


def flatten_to_frames(trajectories: Iterable[dict]) -> Iterator[dict]:
    for traj in trajectories:
        for t in range(len(traj["action"])):
            yield tft.tree_map(lambda x, t=t: np.asarray(x)[t], traj)


def _repeat(make: Callable[[], Iterable]) -> Iterator:
    while True:
        empty = True
        for x in make():
            empty = False
            yield x
        if empty:
            raise ValueError("a dataset of the mix yields no trajectory (empty split, or every episode filtered)")


def _pad_frame(frame: dict, targets: dict) -> dict:
    """Pad action / future_action / proprio to the mix maxima; padded action
    dims are False in action_pad_mask."""
    for keys, target in targets.items():
        node = frame
        for k in keys[:-1]:
            if k not in node:
                break
            node[k] = dict(node[k])
            node = node[k]
        else:
            if keys[-1] not in node:
                continue
            a = node[keys[-1]]
            pad = target - a.shape[-1]
            if pad <= 0:
                continue
            widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
            node[keys[-1]] = np.pad(a, widths)
            if keys == ("action",):
                m = frame.get("action_pad_mask", np.ones(a.shape, bool))
                frame["action_pad_mask"] = np.pad(m, widths, constant_values=False)
    return frame


def _interleave(streams: list[Iterator], weights: list[float], seed: int) -> Iterator:
    if len(streams) == 1:
        yield from streams[0]
        return
    rng = np.random.default_rng([seed, 101])
    while True:
        for k in rng.choice(len(streams), size=1024, p=weights):
            yield next(streams[k])


def _shuffle(items: Iterator, buffer_size: int, seed: int) -> Iterator:
    if buffer_size <= 1:
        yield from items
        return
    rng = np.random.default_rng([seed, 202])
    buf = []
    for x in items:
        if len(buf) < buffer_size:
            buf.append(x)
            continue
        j = int(rng.integers(buffer_size))
        yield buf[j]
        buf[j] = x
    while buf:  # a finite stream drains in random order
        yield buf.pop(int(rng.integers(len(buf))))


def _frame_transform(frame: dict, index: int, *, train: bool, augment: bool, resize_size: tuple[int, int],
                     augment_seed: int, image_dropout_prob: float, stats: LoaderStats | None) -> dict:
    """Decode/resize every image_* camera ([window] frames) and the goal
    images; on the train path, the fused crop+resize+jitter (one draw per
    camera, shared by its history frames) and whole-camera dropout (never
    image_primary)."""
    decode_s = transform_s = 0.0
    obs = dict(frame["observation"])

    def one(img, draws):
        nonlocal decode_s, transform_s
        if isinstance(img, (bytes, bytearray)):
            if len(img) == 0:
                return tft.padding_image(resize_size)
            t = time.perf_counter()
            img = codec.decode_image(img)
            decode_s += time.perf_counter() - t
        t = time.perf_counter()
        out = tft.decode_augment_resize(img, resize_size, draws) if draws else tft.decode_and_resize(img, resize_size)
        transform_s += time.perf_counter() - t
        return out

    for j, key in enumerate(sorted(k for k in obs if k.startswith("image_"))):
        draws = None
        if train and augment:
            draws = codec.JitterDraws.sample(np.random.default_rng([index * 31 + j, augment_seed]))
        img = np.stack([one(im, draws) for im in obs[key]])
        if train and image_dropout_prob > 0.0 and key != "image_primary":
            img = tft.image_dropout(img, np.random.default_rng([index * 37 + j, augment_seed + 1]), image_dropout_prob)
        obs[key] = img
    out = dict(frame)
    out["observation"] = obs
    task = frame.get("task")
    if isinstance(task, dict):
        task = dict(task)
        for key in sorted(k for k in task if k.startswith("goal_image")):
            task[key] = one(task[key], None)
        out["task"] = task
    if stats is not None:
        stats.add(decode_s=decode_s, transform_s=transform_s, frames=1)
    return out


def _collate(frames: list[dict]):
    first = frames[0]
    if isinstance(first, dict):
        return {k: _collate([f[k] for f in frames]) for k in first}
    if isinstance(first, (bytes, bytearray)):
        return _strings(frames)
    return np.stack(frames)


class InterleavedRLDS:
    """The interleaved mix: `frames()` yields transformed frames, `batches(n)`
    fixed-size batches; both are infinite (every dataset repeats)."""

    def __init__(self, sources: list[TrajectorySource], weights: list[float], targets: dict, *, train: bool,
                 traj_kwargs: dict, shuffle_buffer_size: int, resize_size: tuple[int, int],
                 image_dropout_prob: float, seed: int, num_threads: int, stats: LoaderStats):
        self.sources, self.weights, self.targets = sources, weights, targets
        self.train, self.traj_kwargs = train, traj_kwargs
        self.shuffle_buffer_size, self.resize_size = shuffle_buffer_size, tuple(resize_size)
        self.image_dropout_prob, self.seed = image_dropout_prob, seed
        self.num_threads = max(1, num_threads)
        self.stats = stats

    def _untransformed(self) -> Iterator[dict]:
        streams = []
        for src in self.sources:
            trajs = apply_trajectory_transforms(_repeat(lambda src=src: src), train=self.train, seed=self.seed,
                                                **self.traj_kwargs)
            frames = flatten_to_frames(trajs)
            if self.targets:
                frames = (_pad_frame(f, self.targets) for f in frames)
            streams.append(frames)
        return _shuffle(_interleave(streams, self.weights, self.seed), self.shuffle_buffer_size, self.seed)

    def frames(self) -> Iterator[dict]:
        kw = dict(train=self.train, augment=True, resize_size=self.resize_size, augment_seed=self.seed,
                  image_dropout_prob=self.image_dropout_prob if self.train else 0.0, stats=self.stats)
        window = 4 * self.num_threads
        pool = ThreadPoolExecutor(self.num_threads, thread_name_prefix="rlds-frames")
        try:
            pending: deque = deque()
            for index, frame in enumerate(self._untransformed()):
                pending.append(pool.submit(_frame_transform, frame, index, **kw))
                while len(pending) >= window or (pending and pending[0].done()):
                    out = self._result(pending.popleft())
                    if out is not None:
                        yield out
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def _result(self, fut):
        try:
            return fut.result()
        except (codec.CodecError, tfrecord_rlds.RecordError, ValueError) as e:
            # a corrupt frame is logged, counted and skipped (tf.data's ignore_errors)
            self.stats.add(errors=1)
            logger.warning("skipping a frame that failed its transform: %s", e)
            return None

    def batches(self, batch_size: int) -> Iterator[dict]:
        buf: list[dict] = []
        for frame in self.frames():
            buf.append(frame)
            if len(buf) == batch_size:
                yield _collate(buf)
                buf = []


def _last_dim(statistics: dict, field: str) -> int | None:
    node = statistics.get(field)
    return len(node["mean"]) if node else None


def make_interleaved_dataset(
    dataset_kwargs_list: list[dict],
    sample_weights: list[float] | None,
    *,
    train: bool,
    shuffle_buffer_size: int,
    window_size: int = 1,
    action_horizon: int = 1,
    max_action_future: int | None = None,
    subsample_length: int | None = None,
    goal_relabeling_strategy: str | None = None,
    rephraser=None,
    image_dropout_prob: float = 0.0,
    resize_size=(224, 224),
    balance_weights: bool = True,
    seed: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    normalization_type: str = "normal",
    dataset_statistics=None,
    split: str | None = None,
    skip_unlabeled: bool | None = None,
    num_threads: int | None = None,
) -> tuple[InterleavedRLDS, int, dict]:
    """-> (the interleaved mix, total transitions, {name: statistics}).

    normalization_type applies to every dataset of the mix; dataset_statistics
    (path or dict) only to single-dataset mixes; skip_unlabeled only tightens
    datasets the registry marks as labeled."""
    sample_weights = list(sample_weights or [1.0] * len(dataset_kwargs_list))
    if dataset_statistics is not None and len(dataset_kwargs_list) > 1:
        logger.warning("explicit dataset_statistics ignored for a %d-dataset mix (per-dataset statistics are "
                       "computed from the data)", len(dataset_kwargs_list))
        dataset_statistics = None
    loader_stats = LoaderStats()
    sources, sizes, all_stats, dims = [], [], {}, []
    for kwargs in dataset_kwargs_list:
        kw = dict(kwargs)
        load_proprio = kw.pop("load_proprio", True)
        kw.setdefault("normalization_type", normalization_type)
        if split is not None:
            kw.setdefault("split", split)
        if skip_unlabeled is not None and kw.get("skip_unlabeled", True):
            kw["skip_unlabeled"] = skip_unlabeled
        if dataset_statistics is not None:
            kw.setdefault("dataset_statistics", dataset_statistics)
        source, statistics = make_dataset_from_rlds(train=train, shard_index=shard_index, num_shards=num_shards,
                                                    loader_stats=loader_stats, **kw)
        if not load_proprio:  # drop proprio from the canonical layout
            normalize = source.normalize

            def drop_proprio(traj, normalize=normalize):
                traj = normalize(traj)
                traj["observation"] = {k: v for k, v in traj["observation"].items() if k != "proprio"}
                return traj

            source.normalize = drop_proprio
        sources.append(source)
        all_stats[kwargs["name"]] = statistics
        sizes.append(statistics["num_transitions"])
        adim = _last_dim(statistics, "action")
        dims.append({("action",): adim, ("future_action",): adim if max_action_future is not None else None,
                     ("observation", "proprio"): _last_dim(statistics, "proprio") if load_proprio else None})

    # heterogeneous mixes agree on shapes before interleaving
    targets = {}
    for keys in [("action",), ("future_action",), ("observation", "proprio")]:
        present = [d[keys] for d in dims if d[keys] is not None]
        if present and any(d[keys] != max(present) for d in dims):
            targets[keys] = max(present)

    if balance_weights:
        sample_weights = [w * s for w, s in zip(sample_weights, sizes)]
    total = sum(sample_weights)
    sample_weights = [w / total for w in sample_weights]
    mix = InterleavedRLDS(
        sources, sample_weights, targets, train=train,
        traj_kwargs=dict(window_size=window_size, action_horizon=action_horizon, max_action_future=max_action_future,
                         goal_relabeling_strategy=goal_relabeling_strategy, rephraser=rephraser,
                         subsample_length=subsample_length),
        shuffle_buffer_size=shuffle_buffer_size, resize_size=tuple(resize_size),
        image_dropout_prob=image_dropout_prob, seed=seed,
        num_threads=num_threads or os.cpu_count() or 1, stats=loader_stats)
    return mix, int(sum(sizes)), all_stats


# ---------------------------------------------------------------------------
# backend facade for data.dataset.InterleavedDataset
# ---------------------------------------------------------------------------

class RLDSInterleavedBackend:
    def __init__(self, data_cfg, section, split: str, seed: int, shard_index: int = 0, num_shards: int = 1,
                 image_size: int = 224, rephraser=None, normalization_type: str = "normal"):
        from intact_tpu_torch.data.oxe import make_oxe_dataset_kwargs_and_weights

        if getattr(section, "service_address", None):
            raise NotImplementedError(
                "the RLDS backend's data.train.service_address: the tf.data service has no counterpart without "
                "TensorFlow; the port's loader runs on the training host (several hosts shard episodes by rank "
                "instead)")
        kwargs_list, weights = make_oxe_dataset_kwargs_and_weights(section.dataset_mix, str(section.data_path),
                                                                   load_proprio=section.load_proprio)
        train = split == "train"
        threads = getattr(section, "num_parallel_calls", None) or os.cpu_count() or 1
        self._mix, self.num_transitions, self.statistics = make_interleaved_dataset(
            kwargs_list, weights,
            train=train,
            shuffle_buffer_size=section.shuffle_buffer_size,
            window_size=section.window_size or 1,
            action_horizon=section.action_horizon or 1,
            max_action_future=getattr(section, "max_action_future", None),
            subsample_length=getattr(section, "subsample_length", None),
            image_dropout_prob=(getattr(section, "image_dropout_prob", 0.0) or 0.0) if train else 0.0,
            rephraser=rephraser if train else None,
            resize_size=(image_size, image_size),
            seed=seed,
            shard_index=shard_index,
            num_shards=num_shards,
            # the scheme the serving adapters invert, with the explicit
            # statistics file where one is given
            normalization_type=normalization_type,
            dataset_statistics=getattr(section, "dataset_statistics_path", None),
            # "train"/"val" are role markers (the 95/5 split); anything else
            # (e.g. "train[:50%]") is an explicit split
            split=section.split if getattr(section, "split", None) not in (None, "train", "val") else None,
            skip_unlabeled=getattr(section, "skip_unlabeled", None),
            num_threads=min(int(threads), os.cpu_count() or 1),
        )
        self.loader_stats = self._mix.stats

    def batches(self, batch_size: int) -> Iterator[dict]:
        yield from self._mix.batches(batch_size)
