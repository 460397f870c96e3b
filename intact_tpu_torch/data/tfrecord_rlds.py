"""TFRecord reader and writer for TFDS/RLDS datasets, without TensorFlow,
tensorflow_datasets or protobuf (the counterpart of intact_tpu/data/tfrecord_rlds.py).

The OXE distribution format is plain TFRecord shards plus TFDS metadata:

  <data_dir>/<name>/<version>/
      dataset_info.json        (splits, shard lengths)
      features.json            (nested feature spec)
      <name>-<split>.tfrecord-00000-of-000NN

Each RLDS episode is ONE `tf.train.Example` whose step fields are flattened
with '/' separators and concatenated over time:
  steps/observation/image_0   bytes  (one encoded frame per step)
  steps/observation/state     floats (T * dim values)
  steps/action                floats (T * dim values)
  steps/language_instruction  bytes  (one per step)

Here a record is framed as TFRecord frames it (a little-endian uint64
length, the masked CRC32C of those 8 bytes, the data, the masked CRC32C of
the data; both CRCs are checked), and the Example is read by a protobuf wire
decoder of its own. Flat values are reshaped to [T, ...] from features.json,
as the JAX reader's `tf.io.parse_single_example` path does: int64 and float
lists come back as int64 and float32 arrays (uint8 Tensor leaves cast back),
byte lists as object arrays of bytes.
"""

from __future__ import annotations

import itertools
import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from intact_tpu_torch.data import codec

# declared dtype -> wire list; uint8 Tensor leaves travel as int64 lists and
# are cast back after parsing (as the JAX reader's _DTYPES / _CAST_BACK)
_WIRE = {"uint8": "int64", "int32": "int64", "int64": "int64", "float32": "float", "float64": "float",
         "string": "bytes", "bool": "int64"}
_CAST_BACK = {"uint8": np.uint8}


class RecordError(ValueError):
    """A TFRecord file or Example that does not parse."""


def _dim(d) -> int:
    """One dimension entry -> int (proto3-JSON writes {"size": "256"} or "256")."""
    if isinstance(d, dict):
        return int(d.get("size", -1))
    return int(d)


def _find_dataset_dir(data_dir: str | Path, name: str) -> Path:
    """<data_dir>/<name>[/<config>][/<version>] -> the dir holding dataset_info.json."""
    root = Path(data_dir) / name
    if (root / "dataset_info.json").exists():
        return root
    hits = sorted(root.rglob("dataset_info.json"))
    if not hits:
        raise FileNotFoundError(f"no dataset_info.json under {root}")
    return hits[0].parent


def _flatten_features(node: dict, prefix: str = "") -> dict[str, dict]:
    """TFDS features.json -> {flat_key: {wire, shape, encoded_image, cast}}.

    FeaturesDict / Sequence / Tensor / Image / Text / Scalar nodes; a
    Sequence's time axis is dropped (every leaf under `steps` is per-step)."""
    out: dict[str, dict] = {}

    def walk(n: dict, pfx: str):
        cls = n.get("pythonClassName", "")
        content = n.get("content", n)
        if cls.endswith("FeaturesDict") or "featuresDict" in n:
            feats = n.get("featuresDict", {}).get("features") or content.get("features") or {}
            for key, sub in feats.items():
                walk(sub, f"{pfx}/{key}" if pfx else key)
        elif cls.endswith("Sequence") or "sequence" in n:
            walk(n.get("sequence", {}).get("feature") or content.get("feature"), pfx)
        elif cls.endswith("Image") or "image" in n:
            info = n.get("image", content)
            shape = [_dim(d) for d in info.get("shape", {}).get("dimensions", [])] or [-1, -1, 3]
            out[pfx] = {"wire": "bytes", "shape": shape, "encoded_image": True, "cast": None}
        elif cls.endswith("Text"):
            out[pfx] = {"wire": "bytes", "shape": [], "encoded_image": False, "cast": None}
        else:  # Scalar or Tensor
            info = n.get("tensor", content)
            raw = info.get("dtype", "float32")
            shape = [] if cls.endswith("Scalar") else [_dim(d) for d in info.get("shape", {}).get("dimensions", [])]
            out[pfx] = {"wire": _WIRE[raw], "shape": shape, "encoded_image": False, "cast": _CAST_BACK.get(raw)}

    walk(node, prefix)
    return out


def load_feature_spec(ds_dir: Path) -> dict[str, dict]:
    with open(ds_dir / "features.json") as f:
        return _flatten_features(json.load(f))


def _splits(ds_dir: Path) -> list[dict]:
    with open(ds_dir / "dataset_info.json") as f:
        return json.load(f).get("splits", [])


def load_split_info(ds_dir: Path) -> dict[str, int]:
    """split name -> number of episodes (dataset_info.json)."""
    return {s["name"]: sum(int(x) for x in s.get("shardLengths", [])) for s in _splits(ds_dir)}


def load_shard_lengths(ds_dir: Path, split: str) -> list[int]:
    """Per-shard episode counts of a split, [] when absent."""
    for s in _splits(ds_dir):
        if s.get("name") == split:
            return [int(x) for x in s.get("shardLengths", [])]
    return []


def _resolve_split(split: str | None) -> tuple[str, float, float]:
    """'train[:95%]' -> ('train', 0.0, 0.95). Only %-slices; an absolute slice
    ('train[:1000]') raises rather than misparse as a percentage."""
    split = split or "train"
    if "[" not in split:
        return split, 0.0, 1.0
    base, _, sl = split.partition("[")
    lo, _, hi = sl.rstrip("]").partition(":")
    for bound in (lo, hi):
        if bound and not bound.endswith("%"):
            raise ValueError(f"unsupported split slice {split!r}: only %-slices are implemented "
                             "(e.g. 'train[:95%]'); absolute indices would misparse")
    return base, float(lo.rstrip("%")) / 100.0 if lo else 0.0, float(hi.rstrip("%")) / 100.0 if hi else 1.0


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

def iter_records(path: str | Path, skip: int = 0, take: int | None = None) -> Iterator[bytes]:
    """The records of one TFRecord file, both CRCs checked; a bad frame raises
    a RecordError naming the file and the byte offset."""
    with open(path, "rb") as f:
        offset, index = 0, 0
        while take is None or index < skip + take:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise RecordError(f"{path}: truncated record header at byte {offset}")
            length, length_crc = struct.unpack("<QI", head)
            if codec.masked_crc32c(head[:8]) != length_crc:
                raise RecordError(f"{path}: corrupted record length (CRC mismatch) at byte {offset}")
            body = f.read(length + 4)
            if len(body) < length + 4:
                raise RecordError(f"{path}: truncated record of {length} bytes at byte {offset}")
            if index >= skip:
                data = body[:length]
                if codec.masked_crc32c(data) != struct.unpack("<I", body[length:])[0]:
                    raise RecordError(f"{path}: corrupted record data (CRC mismatch) at byte {offset}")
                yield data
            offset += 12 + length + 4
            index += 1


def frame_record(data: bytes) -> bytes:
    length = struct.pack("<Q", len(data))
    return length + struct.pack("<I", codec.masked_crc32c(length)) + data + struct.pack(
        "<I", codec.masked_crc32c(data))


# ---------------------------------------------------------------------------
# tf.train.Example wire format
# ---------------------------------------------------------------------------

def _varint(buf, pos: int) -> tuple[int, int]:
    result, shift = 0, 0
    while True:
        if pos >= len(buf):
            raise RecordError("truncated varint in Example")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _fields(buf, start: int, end: int) -> Iterator[tuple[int, int, int, int]]:
    """(field number, wire type, value or payload start, payload end) over a message."""
    pos = start
    while pos < end:
        key, pos = _varint(buf, pos)
        num, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _varint(buf, pos)
            yield num, wt, v, pos
        elif wt == 1:
            yield num, wt, pos, pos + 8
            pos += 8
        elif wt == 2:
            n, pos = _varint(buf, pos)
            if pos + n > end:
                raise RecordError("length-delimited field runs past its message in Example")
            yield num, wt, pos, pos + n
            pos += n
        elif wt == 5:
            yield num, wt, pos, pos + 4
            pos += 4
        else:
            raise RecordError(f"unsupported protobuf wire type {wt} in Example")
    if pos != end:
        raise RecordError("Example field runs past its message")


def decode_varints(payload: np.ndarray) -> np.ndarray:
    """Packed varints (uint8 array) -> int64 values, vectorised."""
    if payload.size == 0:
        return np.zeros(0, np.int64)
    ends = np.flatnonzero(payload < 0x80)
    if ends.size == 0 or ends[-1] != payload.size - 1:
        raise RecordError("truncated packed varint in Example")
    starts = np.concatenate([[0], ends[:-1] + 1])
    pos = np.arange(payload.size) - np.repeat(starts, ends - starts + 1)
    if pos.max() > 9:
        raise RecordError("varint longer than 10 bytes in Example")
    vals = (payload & 0x7F).astype(np.uint64) << (7 * pos).astype(np.uint64)
    return np.add.reduceat(vals, starts).view(np.int64)


def parse_example(buf: bytes) -> dict[str, tuple[str, object]]:
    """Serialized tf.train.Example -> {key: (kind, values)}, kind 'bytes'
    (list of bytes), 'float' (float32 array) or 'int64' (int64 array);
    packed and unpacked lists both read."""
    mv = memoryview(buf)
    u8 = np.frombuffer(buf, np.uint8)
    out: dict[str, tuple[str, object]] = {}
    for num, wt, a, b in _fields(mv, 0, len(buf)):
        if num != 1 or wt != 2:
            continue  # Example.features is field 1
        for fnum, fwt, fa, fb in _fields(mv, a, b):
            if fnum != 1 or fwt != 2:
                continue  # Features.feature: map entries
            key, feat = None, None
            for enum, ewt, ea, eb in _fields(mv, fa, fb):
                if enum == 1 and ewt == 2:
                    key = bytes(mv[ea:eb]).decode()
                elif enum == 2 and ewt == 2:
                    feat = (ea, eb)
            if key is None:
                raise RecordError("Example map entry without a key")
            out[key] = _parse_feature(mv, u8, *feat) if feat else ("bytes", [])
    return out


def _parse_feature(mv, u8, a: int, b: int) -> tuple[str, object]:
    kind = "bytes"
    vals: list = []
    for num, wt, la, lb in _fields(mv, a, b):  # Feature.kind: 1 bytes, 2 float, 3 int64
        if num == 1 and wt == 2:
            kind = "bytes"
            vals = [bytes(mv[va:vb]) for n, w, va, vb in _fields(mv, la, lb) if n == 1 and w == 2]
        elif num == 2 and wt == 2:
            kind, parts = "float", []
            for n, w, va, vb in _fields(mv, la, lb):
                if n == 1:  # packed (wire 2) or one fixed32 (wire 5)
                    parts.append(np.frombuffer(mv[va:vb], "<f4"))
            vals = np.concatenate(parts).astype(np.float32) if parts else np.zeros(0, np.float32)
        elif num == 3 and wt == 2:
            kind, parts = "int64", []
            for n, w, va, vb in _fields(mv, la, lb):
                if n == 1 and w == 2:
                    parts.append(decode_varints(u8[va:vb]))
                elif n == 1 and w == 0:
                    parts.append(np.array([va], np.uint64).view(np.int64))
            vals = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    return kind, vals


def _key(num: int, wt: int) -> bytes:
    return _encode_varint((num << 3) | wt)


def _encode_varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(num: int, payload: bytes) -> bytes:
    return _key(num, 2) + _encode_varint(len(payload)) + payload


def encode_example(features: dict[str, tuple[str, object]]) -> bytes:
    """{key: (kind, values)} -> serialized tf.train.Example (packed lists)."""
    entries = []
    for key, (kind, vals) in features.items():
        if kind == "bytes":
            body = _len_field(1, b"".join(_len_field(1, bytes(v)) for v in vals))
        elif kind == "float":
            body = _len_field(2, _len_field(1, np.asarray(vals, "<f4").tobytes()))
        else:
            body = _len_field(3, _len_field(1, b"".join(_encode_varint(int(v)) for v in np.asarray(vals).ravel())))
        entries.append(_len_field(1, _len_field(1, key.encode()) + _len_field(2, body)))
    return _len_field(1, b"".join(entries))


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _assign_nested(tree: dict, keys: list[str], value) -> None:
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _strip_steps(tree: dict) -> dict:
    """Hoist RLDS's 'steps' so trajectories look like {observation, action,
    language_instruction, ...}, keeping episode-level metadata beside them."""
    if "steps" not in tree:
        return tree
    out = dict(tree["steps"])
    for k, v in tree.items():
        if k != "steps":
            out.setdefault(k, v)
    return out


def decode_episode(record: bytes, spec: dict[str, dict]) -> dict:
    """One serialized episode -> nested trajectory dict of [T, ...] arrays."""
    ex = parse_example(record)
    out: dict = {}
    for key, info in spec.items():
        kind, vals = ex.get(key, (info["wire"], []))
        if info["wire"] == "bytes":
            arr = np.empty(len(vals), object)
            arr[:] = list(vals)
        else:
            arr = np.asarray(vals, np.float32 if info["wire"] == "float" else np.int64)
            shape = info["shape"]
            if shape and all(d > 0 for d in shape):
                arr = arr.reshape([-1] + list(shape))
            if info.get("cast") is not None:
                arr = arr.astype(info["cast"])
        _assign_nested(out, key.split("/"), arr)
    return _strip_steps(out)


class RLDSEpisodes:
    """The episodes of one split (or %-slice) of a TFDS-layout dataset, as an
    iterable that can be walked again (each walk reads the files anew).

    %-slices apply per episode through the shards' lengths, so train and val
    partitions are disjoint; with `shuffle_files` the (file, skip, take)
    entries are walked in an order drawn from `numpy.random.default_rng(seed)`."""

    def __init__(self, data_dir: str | Path, name: str, split: str | None = "train",
                 shuffle_files: bool = True, seed: int = 0):
        self.ds_dir = _find_dataset_dir(data_dir, name)
        self.spec = load_feature_spec(self.ds_dir)
        base, lo, hi = _resolve_split(split)
        files = sorted(str(p) for p in self.ds_dir.glob(f"*-{base}.tfrecord-*"))
        if not files:
            raise FileNotFoundError(f"no {base} tfrecord shards in {self.ds_dir}")
        total = load_split_info(self.ds_dir).get(base, 0)
        lengths = load_shard_lengths(self.ds_dir, base)
        sliced = lo > 0.0 or hi < 1.0
        lo_idx, hi_idx = int(round(lo * total)), int(round(hi * total))
        if sliced and not (len(lengths) == len(files) and sum(lengths) == total):
            # without per-shard lengths: count the records, in file order
            lengths = [sum(1 for _ in iter_records(f)) for f in files]
            total = sum(lengths)
            lo_idx, hi_idx = int(round(lo * total)), int(round(hi * total))
        if sliced:
            entries, start = [], 0
            for f, n in zip(files, lengths):
                a, b = max(0, lo_idx - start), min(n, hi_idx - start)
                if b > a:
                    entries.append((f, a, b - a))
                start += n
        else:
            entries = [(f, 0, None) for f in files]
        if shuffle_files:
            np.random.default_rng(seed).shuffle(entries)
        self.entries = entries

    def records(self) -> Iterator[bytes]:
        for f, skip, take in self.entries:
            yield from iter_records(f, skip, take)

    def __iter__(self) -> Iterator[dict]:
        for rec in self.records():
            yield decode_episode(rec, self.spec)


def read_rlds_dataset(data_dir: str | Path, name: str, split: str | None = "train", shuffle_files: bool = True,
                      seed: int = 0) -> RLDSEpisodes:
    """-> the episodes of `split` as nested trajectory dicts [T, ...]."""
    return RLDSEpisodes(data_dir, name, split, shuffle_files, seed)


# ---------------------------------------------------------------------------
# writer (tests, chip_smoke.py and offline preprocessing)
# ---------------------------------------------------------------------------

def write_rlds_dataset(
    out_dir: str | Path,
    name: str,
    episodes: Iterable[dict],
    *,
    split: str = "train",
    num_shards: int = 1,
    image_keys: tuple[str, ...] = ("image_0",),
    version: str = "1.0.0",
    image_encoding: str = "png",  # "png" | "jpeg" (quality 95)
) -> Path:
    """Write trajectories as TFDS-layout TFRecord shards + metadata, the layout
    intact_tpu's writer and reader use.

    episodes: iterable of {observation: {...}, action: [T, d], ...} numpy trees
    (a generator streams, round-robin over the shards). uint8 [T, H, W, 3]
    camera frames are encoded one per step, an episode's frames on a thread
    pool."""
    from intact_tpu_torch.data.preprocess import _is_image_key

    if image_encoding not in ("png", "jpeg"):
        raise ValueError(f"image_encoding must be 'png' or 'jpeg', got {image_encoding!r}")
    ds_dir = Path(out_dir) / name / version
    ds_dir.mkdir(parents=True, exist_ok=True)

    def flatten(tree, pfx=""):
        for k, v in tree.items():
            key = f"{pfx}/{k}" if pfx else k
            if isinstance(v, dict):
                yield from flatten(v, key)
            else:
                yield key, np.asarray(v)

    def camera(k: str) -> bool:
        # explicit image_keys plus the registry-wide camera names (rgb_static,
        # cam_high, ...): a camera missed here would go out as int64 lists
        return k in image_keys or _is_image_key(k)

    it = iter(episodes)
    first_episode = next(it)
    steps_features: dict = {}
    for key, arr in flatten({"steps": first_episode}):
        sub = key.split("/")[1:]
        if camera(sub[-1]) and arr.dtype == np.uint8:
            node = {"pythonClassName": "tensorflow_datasets.core.features.image_feature.Image",
                    "image": {"shape": {"dimensions": [{"size": int(s)} for s in arr.shape[1:]]}, "dtype": "uint8"}}
        elif arr.dtype.kind in ("S", "U", "O"):
            node = {"pythonClassName": "tensorflow_datasets.core.features.text_feature.Text"}
        else:
            node = {"pythonClassName": "tensorflow_datasets.core.features.tensor_feature.Tensor",
                    "tensor": {"shape": {"dimensions": [{"size": int(s)} for s in arr.shape[1:]]},
                               "dtype": str(arr.dtype)}}
        steps_features["/".join(sub)] = node

    def nest(flat: dict[str, dict]) -> dict:
        tree: dict = {}
        for key, node in flat.items():
            parts = key.split("/")
            cur = tree
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = ("LEAF", node)

        def to_feature(sub) -> dict:
            if isinstance(sub, tuple) and sub[0] == "LEAF":
                return sub[1]
            return {"pythonClassName": "tensorflow_datasets.core.features.features_dict.FeaturesDict",
                    "featuresDict": {"features": {k: to_feature(v) for k, v in sub.items()}}}

        return to_feature(tree)

    features = {"pythonClassName": "tensorflow_datasets.core.features.features_dict.FeaturesDict",
                "featuresDict": {"features": {"steps": {
                    "pythonClassName": "tensorflow_datasets.core.features.sequence_feature.Sequence",
                    "sequence": {"feature": nest(steps_features)}}}}}
    (ds_dir / "features.json").write_text(json.dumps(features, indent=1))

    encode = codec.encode_png if image_encoding == "png" else codec.encode_jpeg

    def serialize(ep, pool: ThreadPoolExecutor) -> bytes:
        feats = {}
        for key, arr in flatten({"steps": ep}):
            sub = key.split("/")[1:]
            if camera(sub[-1]) and arr.dtype == np.uint8 and arr.ndim >= 3:
                feats[key] = ("bytes", list(pool.map(encode, arr)))  # the codec and zlib release the GIL
            elif arr.dtype.kind in ("S", "U", "O"):
                feats[key] = ("bytes", [s.encode() if isinstance(s, str) else bytes(s) for s in arr])
            elif arr.dtype.kind in ("i", "u", "b"):
                feats[key] = ("int64", arr.reshape(-1).astype(np.int64))
            else:
                feats[key] = ("float", arr.reshape(-1).astype(np.float32))
        return encode_example(feats)

    per_shard = [0] * num_shards
    files = [open(ds_dir / f"{name}-{split}.tfrecord-{i:05d}-of-{num_shards:05d}", "wb") for i in range(num_shards)]
    try:
        with ThreadPoolExecutor(os.cpu_count() or 1, thread_name_prefix="rlds-encode") as pool:
            for idx, ep in enumerate(itertools.chain([first_episode], it)):
                shard = idx % num_shards
                files[shard].write(frame_record(serialize(ep, pool)))
                per_shard[shard] += 1
    finally:
        for f in files:
            f.close()
    (ds_dir / "dataset_info.json").write_text(json.dumps({
        "name": name, "version": version,
        "splits": [{"name": split, "shardLengths": [str(c) for c in per_shard]}],
    }, indent=1))
    return ds_dir
