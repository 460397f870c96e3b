"""The port's RLDS training-data path against the JAX package's tf.data one,
on the CPU: the TFRecord / tf.train.Example reader against TF's parse, both
directions of the TFDS layout (each package's writer read by the other's
reader), the val path of `make_interleaved_dataset` element for element (a
single dataset and a padded two-dataset mix), statistics, the train path's
random draws (statistical bounds with fixed seeds), offline preprocessing,
the dataset facade, and a tiny Pi0 trainer taking 2 updates from an RLDS
directory with paraphrasing on. No socket is opened."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from intact_tpu.data import rlds as jrlds  # noqa: E402
from intact_tpu.data import stats as jstats  # noqa: E402
from intact_tpu.data import tfrecord_rlds as jtfr  # noqa: E402
from intact_tpu.data.oxe import make_oxe_dataset_kwargs_and_weights as j_oxe_kwargs  # noqa: E402
from intact_tpu_torch.data import codec  # noqa: E402
from intact_tpu_torch.data import rlds as trlds  # noqa: E402
from intact_tpu_torch.data import tf_transforms as ttft  # noqa: E402
from intact_tpu_torch.data import tfrecord_rlds as ttfr  # noqa: E402
from intact_tpu_torch.data.oxe import make_oxe_dataset_kwargs_and_weights as t_oxe_kwargs  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
INSTRUCTIONS = ["put the carrot on the plate", "put the spoon on the towel"]


def bridge_episode(rng, T, hw=32, instruction=None):
    return {
        "observation": {
            "image_0": codec_frames(rng, T, hw),
            "state": rng.normal(size=(T, 7)).astype(np.float32),
        },
        "action": (rng.normal(size=(T, 7)) * 0.05 + 0.5).astype(np.float32),
        "language_instruction": np.array([instruction or INSTRUCTIONS[T % 2]] * T),
    }


def codec_frames(rng, T, hw):
    yy, xx = np.mgrid[0:hw, 0:hw]
    base = np.stack([xx * 255 // hw, yy * 255 // hw, (xx + yy) * 127 // hw], -1)
    return np.stack([np.clip(base + rng.integers(-20, 20, base.shape), 0, 255) for _ in range(T)]).astype(np.uint8)


@pytest.fixture(scope="module")
def bridge_dirs(tmp_path_factory):
    """One bridge_dataset written by the port (JPEG) and one by the JAX
    package (PNG), 20 episodes each in one shard (the val split is the last
    5%: one episode)."""
    rng = np.random.default_rng(0)
    episodes = [bridge_episode(rng, T) for T in [6, 7, 8, 9, 5] * 4]
    port_root = tmp_path_factory.mktemp("port_rlds")
    ttfr.write_rlds_dataset(port_root, "bridge_dataset", episodes, image_encoding="jpeg")
    jax_root = tmp_path_factory.mktemp("jax_rlds")
    jtfr.write_rlds_dataset(jax_root, "bridge_dataset", episodes)
    return port_root, jax_root, episodes


def flat(tree, pfx=""):
    out = {}
    for k, v in tree.items():
        key = f"{pfx}/{k}" if pfx else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: v})
    return out


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

def test_example_decoder_matches_tf_parse():
    rng = np.random.default_rng(3)
    feats = {
        "b": tf.train.Feature(bytes_list=tf.train.BytesList(value=[b"", b"x" * 300, bytes(range(256))])),
        "f": tf.train.Feature(float_list=tf.train.FloatList(value=rng.normal(size=37).astype(np.float32))),
        "i": tf.train.Feature(int64_list=tf.train.Int64List(value=[0, 1, -1, 2 ** 40, -(2 ** 62), 127, 128, 300])),
        "e": tf.train.Feature(float_list=tf.train.FloatList(value=[])),
    }
    data = tf.train.Example(features=tf.train.Features(feature=feats)).SerializeToString()
    spec = {"b": tf.io.VarLenFeature(tf.string), "f": tf.io.VarLenFeature(tf.float32),
            "i": tf.io.VarLenFeature(tf.int64), "e": tf.io.VarLenFeature(tf.float32)}
    ref = {k: tf.sparse.to_dense(v).numpy() for k, v in tf.io.parse_single_example(data, spec).items()}
    ours = ttfr.parse_example(data)
    assert ours["b"][1] == list(ref["b"])
    np.testing.assert_array_equal(ours["f"][1], ref["f"])
    np.testing.assert_array_equal(ours["i"][1], ref["i"])
    assert ours["i"][1].dtype == np.int64 and len(ours["e"][1]) == 0
    # our encoder's bytes through TF's parser
    back = tf.io.parse_single_example(ttfr.encode_example({k: v for k, v in ours.items()}), spec)
    np.testing.assert_array_equal(tf.sparse.to_dense(back["i"]).numpy(), ref["i"])
    assert list(tf.sparse.to_dense(back["b"]).numpy()) == list(ref["b"])


def test_unpacked_lists_decode():
    """proto2-style unpacked float/int64 fields (one tag per value) read too."""
    inner_f = b"".join(b"\x0d" + np.float32(v).tobytes() for v in (1.5, -2.0))
    inner_i = b"".join(b"\x08" + ttfr._encode_varint(v) for v in (5, -3))
    feat = lambda kind, body: ttfr._len_field(kind, body)
    entry = lambda key, f: ttfr._len_field(1, ttfr._len_field(1, key.encode()) + ttfr._len_field(2, f))
    data = ttfr._len_field(1, entry("f", feat(2, inner_f)) + entry("i", feat(3, inner_i)))
    out = ttfr.parse_example(data)
    np.testing.assert_array_equal(out["f"][1], [1.5, -2.0])
    np.testing.assert_array_equal(out["i"][1], [5, -3])


def test_tfrecord_framing_both_ways(tmp_path):
    path = tmp_path / "a.tfrecord"
    payloads = [b"first", b"", b"x" * 5000]
    with tf.io.TFRecordWriter(str(path)) as w:
        for p in payloads:
            w.write(p)
    assert list(ttfr.iter_records(path)) == payloads
    assert list(ttfr.iter_records(path, skip=1, take=1)) == [b""]
    ours = tmp_path / "b.tfrecord"
    ours.write_bytes(b"".join(ttfr.frame_record(p) for p in payloads))
    assert [r.numpy() for r in tf.data.TFRecordDataset(str(ours))] == payloads


@pytest.mark.parametrize("where,what", [(20, "data"), (3, "length")])
def test_corrupted_record_raises(tmp_path, where, what):
    path = tmp_path / "c.tfrecord"
    raw = bytearray(ttfr.frame_record(b"payload of one record" * 4))
    raw[where] ^= 0x40
    path.write_bytes(bytes(raw))
    with pytest.raises(ttfr.RecordError, match=f"{path}: corrupted record {what} .CRC mismatch. at byte 0"):
        list(ttfr.iter_records(path))


def test_jax_writer_to_port_reader(bridge_dirs):
    _, jax_root, episodes = bridge_dirs
    got = list(ttfr.read_rlds_dataset(jax_root, "bridge_dataset", shuffle_files=False))
    ref = list(jtfr.read_rlds_dataset(jax_root, "bridge_dataset", shuffle_files=False).as_numpy_iterator())
    assert len(got) == len(ref) == len(episodes)
    for g, r, ep in zip(got, ref, episodes):
        fg, fr = flat(g), flat(r)
        assert set(fg) == set(fr)
        for k, v in fr.items():
            if v.dtype == object:
                assert list(fg[k]) == list(v), k
            else:
                assert fg[k].dtype == v.dtype, k
                np.testing.assert_array_equal(fg[k], v, err_msg=k)
        np.testing.assert_array_equal(codec.decode_image(g["observation"]["image_0"][0]), ep["observation"]["image_0"][0])


def test_port_writer_to_jax_reader(bridge_dirs):
    port_root, _, episodes = bridge_dirs
    ref = list(jtfr.read_rlds_dataset(port_root, "bridge_dataset", shuffle_files=False).as_numpy_iterator())
    assert len(ref) == len(episodes)
    for r, ep in zip(ref, episodes):
        np.testing.assert_array_equal(r["action"], ep["action"])
        np.testing.assert_array_equal(r["observation"]["state"], ep["observation"]["state"])
        assert r["language_instruction"][0] == ep["language_instruction"][0].encode()
        data = r["observation"]["image_0"][0]  # the port's JPEG: TF's bytes at quality 95
        assert data == tf.io.encode_jpeg(ep["observation"]["image_0"][0], quality=95).numpy()
        np.testing.assert_array_equal(tf.io.decode_image(data).numpy(), codec.decode_image(data))


def test_percent_slices_and_uint8_tensors(tmp_path):
    rng = np.random.default_rng(2)
    eps = [{"observation": {"rgb_static": rng.integers(0, 255, (T, 8, 8, 3), dtype=np.uint8),
                            "seg": rng.integers(0, 9, (T, 4)).astype(np.uint8)},
            "action": rng.normal(size=(T, 7)).astype(np.float32), "language_instruction": np.array(["a"] * T)}
           for T in (3, 4, 5, 6)]
    ttfr.write_rlds_dataset(tmp_path, "taco_play", eps, num_shards=2)
    tr = list(ttfr.read_rlds_dataset(tmp_path, "taco_play", split="train[:50%]", seed=3))
    va = list(ttfr.read_rlds_dataset(tmp_path, "taco_play", split="train[50%:]", seed=4))
    assert sorted(len(t["action"]) for t in tr + va) == [3, 4, 5, 6] and tr and va
    got = list(ttfr.read_rlds_dataset(tmp_path, "taco_play", shuffle_files=False))[0]
    assert got["observation"]["seg"].dtype == np.uint8 and got["observation"]["rgb_static"].dtype == object
    with pytest.raises(ValueError, match="only %-slices"):
        ttfr.read_rlds_dataset(tmp_path, "taco_play", split="train[:2]")
    with pytest.raises(FileNotFoundError):
        ttfr.read_rlds_dataset(tmp_path, "nope")


# ---------------------------------------------------------------------------
# the pipeline against the JAX one
# ---------------------------------------------------------------------------

def jax_frames(ds, n):
    out = []
    for frame in ds.take(n).as_numpy_iterator():
        out.append(frame)
    return out


def port_frames(mix, n):
    it = mix.frames()
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def assert_frame_close(ours, ref, label):
    fo, fr = flat(ours), flat(ref)
    assert set(fo) == set(fr), (label, sorted(set(fo) ^ set(fr)))
    for k, v in fr.items():
        o = fo[k]
        if isinstance(v, (bytes, np.bytes_)):
            assert o == v, (label, k)
        elif k.startswith("observation/image"):
            assert o.shape == v.shape and o.dtype == v.dtype, (label, k)
            assert int(np.abs(o.astype(int) - v).max()) <= 1, (label, k)
        else:
            v = np.asarray(v)
            assert np.asarray(o).dtype == v.dtype, (label, k, np.asarray(o).dtype, v.dtype)
            np.testing.assert_allclose(o, v, rtol=1e-6, atol=1e-6, err_msg=f"{label} {k}")


@pytest.fixture(scope="module")
def val_single(bridge_dirs, tmp_path_factory):
    port_root, _, _ = bridge_dirs
    common = dict(train=False, shuffle_buffer_size=1, window_size=2, action_horizon=4, max_action_future=6,
                  resize_size=(24, 24), seed=0)
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("INTACT_STATS_CACHE", str(tmp_path_factory.mktemp("jstats")))
        jk, jw = j_oxe_kwargs("bridge", str(port_root))
        jds, jtotal, jst = jrlds.make_interleaved_dataset(jk, jw, **common)
        ref = jax_frames(jds, 24)
        mp.setenv("INTACT_STATS_CACHE", str(tmp_path_factory.mktemp("tstats")))
        tk, tw = t_oxe_kwargs("bridge", str(port_root))
        mix, ttotal, tst = trlds.make_interleaved_dataset(tk, tw, num_threads=3, **common)
        ours = port_frames(mix, 24)
    finally:
        mp.undo()
    return ref, ours, (jtotal, jst), (ttotal, tst)


def test_val_path_single_dataset_matches_jax(val_single):
    ref, ours, _, _ = val_single
    assert len(ours) == len(ref) == 24  # more than one pass over the one val episode: the repeat
    for i, (o, r) in enumerate(zip(ours, ref)):
        assert_frame_close(o, r, f"frame {i}")


def test_statistics_equal_jax(val_single):
    _, _, (jtotal, jst), (ttotal, tst) = val_single
    assert ttotal == jtotal
    assert tst == jst  # computed from the same full split, standardized identically: exact


def test_statistics_cache_path(tmp_path, monkeypatch):
    from intact_tpu_torch.data import stats as tstats

    inputs = ["bridge_dataset", "/data", "full"]
    monkeypatch.delenv("INTACT_STATS_CACHE", raising=False)
    assert tstats.statistics_cache_path(inputs).parent != jstats.statistics_cache_path(inputs).parent
    assert tstats.statistics_cache_path(inputs).name == jstats.statistics_cache_path(inputs).name
    monkeypatch.setenv("INTACT_STATS_CACHE", str(tmp_path))
    assert tstats.statistics_cache_path(inputs) == jstats.statistics_cache_path(inputs)
    calls = []
    stats = tstats.get_dataset_statistics(lambda: calls.append(1) or [{"action": np.ones((3, 2))}], inputs)
    again = tstats.get_dataset_statistics(lambda: calls.append(1) or [], inputs)
    assert stats == again and calls == [1] and stats["num_transitions"] == 3


def _toy_raw(n, adim, pdim, lang, seed):
    rng = np.random.default_rng(seed)
    return [{"observation": {"img": rng.integers(0, 255, (T, 16, 16, 3), dtype=np.uint8),
                             "st": rng.normal(size=(T, pdim)).astype(np.float32)},
             "action": rng.normal(size=(T, adim)).astype(np.float32),
             "language_instruction": np.array([lang] * T)} for T in ([5, 6, 7] * n)[:n]]


def _std(traj):
    return {"observation": {"image_primary": traj["observation"]["img"], "proprio": traj["observation"]["st"]},
            "task": {"language_instruction": traj["language_instruction"]}, "action": traj["action"]}


def test_val_path_padded_two_dataset_mix_matches_jax(tmp_path, monkeypatch):
    """An EEF (7-d action, 7-d proprio) and a bimanual blank-language dataset
    (14-d, 8-d): padded to the mix maxima with action_pad_mask. The
    interleave's draws are each package's own, so each dataset's sub-stream
    is compared in order."""
    ttfr.write_rlds_dataset(tmp_path, "toy_eef", _toy_raw(20, 7, 7, "move the thing", 7), image_keys=("img",))
    ttfr.write_rlds_dataset(tmp_path, "toy_bimanual", _toy_raw(20, 14, 8, "", 14), image_keys=("img",))
    kwargs = [
        {"name": "toy_eef", "data_dir": str(tmp_path), "standardize_fn": _std,
         "action_normalization_mask": [True] * 6 + [False], "skip_unlabeled": True},
        {"name": "toy_bimanual", "data_dir": str(tmp_path), "standardize_fn": _std,
         "action_normalization_mask": [True] * 14, "skip_unlabeled": False},
    ]
    common = dict(train=False, shuffle_buffer_size=1, window_size=1, action_horizon=2, resize_size=(16, 16), seed=0)
    monkeypatch.setenv("INTACT_STATS_CACHE", str(tmp_path / "jstats"))
    jds, _, jst = jrlds.make_interleaved_dataset(kwargs, [1.0, 1.0], **common)
    ref = jax_frames(jds, 60)
    monkeypatch.setenv("INTACT_STATS_CACHE", str(tmp_path / "tstats"))
    mix, _, tst = trlds.make_interleaved_dataset(kwargs, [1.0, 1.0], num_threads=2, **common)
    ours = port_frames(mix, 60)
    assert tst == jst

    def split(frames):  # the EEF frames have a zero-padded 8th proprio dim
        eef = [f for f in frames if f["observation"]["proprio"][0, 7] == 0.0]
        return eef, [f for f in frames if f["observation"]["proprio"][0, 7] != 0.0]

    for label, o_stream, r_stream in zip(("eef", "bimanual"), split(ours), split(ref)):
        n = min(len(o_stream), len(r_stream))
        assert n >= 10, (label, len(o_stream), len(r_stream))
        for i in range(n):
            assert_frame_close(o_stream[i], r_stream[i], f"{label} frame {i}")
    eef = split(ours)[0][0]
    assert eef["action"].shape[-1] == 14 and not eef["action_pad_mask"][..., 7:].any()


def test_train_path_structure_matches_jax(bridge_dirs, tmp_path, monkeypatch):
    """The train path (augment, subsample, paraphrase) yields batches of the
    JAX pipeline's keys, shapes and dtypes."""
    from intact_tpu.data.task_augmentation import Rephraser as JRephraser
    from intact_tpu_torch.data.task_augmentation import Rephraser

    port_root, _, _ = bridge_dirs
    table = {INSTRUCTIONS[0]: ["place the carrot onto the plate"]}
    common = dict(train=True, shuffle_buffer_size=8, window_size=1, action_horizon=4, max_action_future=6,
                  subsample_length=5, resize_size=(24, 24), seed=1, batch_size=None)
    monkeypatch.setenv("INTACT_STATS_CACHE", str(tmp_path / "j"))
    jk, jw = j_oxe_kwargs("bridge", str(port_root))
    jds, _, _ = jrlds.make_interleaved_dataset(jk, jw, rephrase_table=JRephraser(table).to_tf_table(), **common)
    jb = next(iter(jds.batch(4).as_numpy_iterator()))
    monkeypatch.setenv("INTACT_STATS_CACHE", str(tmp_path / "t"))
    tk, tw = t_oxe_kwargs("bridge", str(port_root))
    common.pop("batch_size")
    mix, _, _ = trlds.make_interleaved_dataset(tk, tw, rephraser=Rephraser(table), num_threads=2, **common)
    it = mix.batches(4)
    tb = next(it)
    it.close()
    fj, ft = flat(jb), flat(tb)
    assert set(fj) == set(ft)
    for k, v in fj.items():
        assert ft[k].shape == v.shape and ft[k].dtype == v.dtype, (k, ft[k].shape, v.shape, ft[k].dtype, v.dtype)


# ---------------------------------------------------------------------------
# the train path's draws (the port's own streams): statistical checks
# ---------------------------------------------------------------------------

def test_interleave_shares():
    streams = [iter(lambda: 0, 1), iter(lambda: 1, 2)]  # endless 0s and 1s
    draws = np.array([x for x, _ in zip(trlds._interleave(streams, [0.3, 0.7], seed=5), range(4000))])
    share = (draws == 1).mean()
    assert abs(share - 0.7) < 4 * np.sqrt(0.21 / 4000)


def test_balanced_weights_follow_transitions(tmp_path, monkeypatch):
    monkeypatch.setenv("INTACT_STATS_CACHE", str(tmp_path / "s"))
    ttfr.write_rlds_dataset(tmp_path, "a", _toy_raw(4, 7, 7, "x", 1), image_keys=("img",))
    ttfr.write_rlds_dataset(tmp_path, "b", _toy_raw(9, 7, 7, "y", 2), image_keys=("img",))
    kw = [{"name": n, "data_dir": str(tmp_path), "standardize_fn": _std} for n in "ab"]
    mix, total, st = trlds.make_interleaved_dataset(kw, [1.0, 2.0], train=True, shuffle_buffer_size=1)
    sizes = [st["a"]["num_transitions"], st["b"]["num_transitions"]]
    assert total == sum(sizes)
    np.testing.assert_allclose(mix.weights, np.array([1.0, 2.0]) * sizes / np.dot([1.0, 2.0], sizes))


def test_image_dropout_rate():
    frame = {"observation": {"image_primary": np.full((1, 8, 8, 3), 9, np.uint8),
                             "image_wrist": np.full((1, 8, 8, 3), 9, np.uint8)}}
    kw = dict(train=True, augment=False, resize_size=(8, 8), augment_seed=3, image_dropout_prob=0.3, stats=None)
    outs = [trlds._frame_transform(frame, i, **kw) for i in range(600)]
    assert all(o["observation"]["image_primary"].all() for o in outs)  # the primary camera is never dropped
    rate = np.mean([not o["observation"]["image_wrist"].any() for o in outs])
    assert abs(rate - 0.3) < 4 * np.sqrt(0.21 / 600)


def test_paraphrase_rate():
    from intact_tpu_torch.data.task_augmentation import Rephraser

    r = Rephraser({"open the drawer": ["pull the drawer open", "open that drawer"]}, rephrase_prob=0.5)
    orig = np.array([b"open the drawer"] * 6, object)
    changed = [not np.array_equal(r.rephrase_trajectory(orig, np.random.default_rng([0, i])), orig)
               for i in range(1000)]
    # a rephrased trajectory keeps every frame's original with (1/3)^6: ~0.5 are changed
    assert abs(np.mean(changed) - 0.5 * (1 - 3.0 ** -6)) < 4 * np.sqrt(0.25 / 1000)
    other = np.array([b"unknown"] * 3, object)
    assert r.rephrase_trajectory(other, np.random.default_rng(0)) is other


def test_goal_relabel_range_and_share():
    n, reached_share, spread = 20, [], []
    for i in range(300):
        traj = {"observation": {"image_primary": np.arange(n)}, "action": np.zeros((n, 2), np.float32)}
        out = ttft.uniform_goal_relabel(traj, 0.3, np.random.default_rng([1, i]))
        goal, reward = out["task"]["timestep"], out["reward"]
        t = np.arange(n)
        assert (goal >= t).all() and (goal <= n - 1).all() and goal[-1] == n - 1
        np.testing.assert_array_equal(out["task"]["goal_image_primary"], goal)
        assert ((reward == 0) == (goal == t)).all() or (goal[reward == -1] > t[reward == -1]).all()
        reached_share.append((reward[:-1] == 0).mean())
        far = reward[:-2] == -1
        spread += list((goal[:-2][far] - t[:-2][far] - 1) / (n - 2 - t[:-2][far]))
    assert abs(np.mean(reached_share) - 0.3) < 0.02
    assert abs(np.mean(spread) - 0.5) < 0.03  # uniform over i+1 .. n-1


def test_goal_relabel_given_indices_matches_jax():
    from intact_tpu.data import tf_transforms as jtft

    n = 9
    rng = np.random.default_rng(4)
    traj = {"observation": {"image_primary": np.array([f"f{t}".encode() for t in range(n)], object)},
            "action": rng.normal(size=(n, 7)).astype(np.float32)}
    ref = jtft.uniform_goal_relabel_tf({"observation": {"image_primary": tf.constant(traj["observation"]["image_primary"])},
                                        "action": tf.constant(traj["action"])}, 0.3, tf.constant([2, 3]))
    goal = ref["task"]["timestep"].numpy()
    out = ttft.apply_goal_relabel(dict(traj), goal, ref["reward"].numpy() == 0)
    assert list(out["task"]["goal_image_primary"]) == list(ref["task"]["goal_image_primary"].numpy())
    np.testing.assert_array_equal(out["reward"], ref["reward"].numpy())


@pytest.mark.parametrize("window,horizon,future", [(1, 4, None), (2, 3, 5), (3, 1, 2)])
def test_chunking_matches_jax(window, horizon, future):
    from intact_tpu.data import tf_transforms as jtft

    rng = np.random.default_rng(window)
    n = 7
    traj = {"observation": {"proprio": rng.normal(size=(n, 5)).astype(np.float32)},
            "task": {"timestep": np.full(n, 5, np.int32)},
            "action": rng.normal(size=(n, 4)).astype(np.float32), "action_pad_mask": np.ones((n, 4), bool)}
    ref = jtft.chunk_act_obs_tf(to_tf(traj), window, horizon, future)
    out = ttft.chunk_act_obs(traj, window, horizon, future)
    fr, fo = flat(ref), flat(out)
    assert set(fr) == set(fo)
    for k, v in fr.items():
        np.testing.assert_allclose(fo[k], v.numpy(), rtol=1e-6, err_msg=k)


def to_tf(tree):
    return {k: to_tf(v) for k, v in tree.items()} if isinstance(tree, dict) else tf.constant(tree)


# ---------------------------------------------------------------------------
# preprocess, the facade, the trainer, the import guard
# ---------------------------------------------------------------------------

def test_modify_rlds_dataset(bridge_dirs, tmp_path):
    from intact_tpu_torch.data.preprocess import modify_rlds_dataset

    _, jax_root, episodes = bridge_dirs
    out = modify_rlds_dataset(jax_root, "bridge_dataset", tmp_path, ["resize_and_jpeg_encode"], image_size=16,
                              num_workers=2, num_shards=2, limit=3)
    got = list(jtfr.read_rlds_dataset(tmp_path, "bridge_dataset", shuffle_files=False).as_numpy_iterator())
    assert out.exists() and len(got) == 3
    want = codec.resize_lanczos3(episodes[0]["observation"]["image_0"][0], (16, 16))
    assert got[0]["observation"]["image_0"][0] == codec.encode_jpeg(want)  # lanczos3, then JPEG at quality 95
    assert tf.io.decode_image(got[0]["observation"]["image_0"][0]).numpy().shape == (16, 16, 3)
    with pytest.raises(ValueError, match="differ"):
        modify_rlds_dataset(jax_root, "bridge_dataset", jax_root, ["resize"])
    with pytest.raises(KeyError, match="unknown mod"):
        modify_rlds_dataset(jax_root, "bridge_dataset", tmp_path / "x", ["nope"])


def test_proprio_conversions_match_jax():
    from intact_tpu.data import preprocess as jpre
    from intact_tpu_torch.data import preprocess as tpre

    rng = np.random.default_rng(0)
    q = rng.normal(size=(5, 4))
    ep = {"observation": {"proprio": np.concatenate([rng.normal(size=(5, 3)), q / np.linalg.norm(q, axis=1,
                                                                                              keepdims=True),
                                                      rng.normal(size=(5, 1))], 1).astype(np.float32)}}
    np.testing.assert_array_equal(tpre.proprio_quat_to_euler(ep)["observation"]["proprio"],
                                  jpre.proprio_quat_to_euler(ep)["observation"]["proprio"])
    e = tpre.proprio_quat_to_euler(ep)
    np.testing.assert_array_equal(tpre.proprio_euler_to_quat(e)["observation"]["proprio"],
                                  jpre.proprio_euler_to_quat(e)["observation"]["proprio"])


def _data_cfg(root, **kw):
    from intact_tpu_torch.config.pipeline import DataConfig

    cfg = DataConfig(**kw)
    for section in (cfg.train, cfg.val):
        section.data_path = Path(root)
        section.dataset_mix = "bridge"
        section.window_size, section.action_horizon = 1, 4
        section.shuffle_buffer_size = 4
        section.max_action_future, section.subsample_length = None, None
        section.num_parallel_calls = 2
    return cfg


def test_dataset_auto_resolution(bridge_dirs, tmp_path, monkeypatch):
    from intact_tpu_torch.data.dataset import InterleavedDataset

    monkeypatch.setenv("INTACT_STATS_CACHE", str(tmp_path))
    port_root, _, _ = bridge_dirs
    ds = InterleavedDataset(_data_cfg(port_root), 3, image_size=24)
    assert ds.backend == "rlds" and len(ds) > 0
    batch = next(iter(ds))
    assert batch["observation"]["image_primary"].shape == (3, 1, 24, 24, 3)
    assert InterleavedDataset(_data_cfg(tmp_path / "missing"), 3).backend == "synthetic"
    with pytest.raises(RuntimeError, match="paraphrase"):
        monkeypatch.setattr("intact_tpu_torch.data.task_augmentation.Rephraser.from_hub",
                            classmethod(lambda cls, **kw: (_ for _ in ()).throw(OSError("no hub"))))
        InterleavedDataset(_data_cfg(port_root), 3, task_paraphrase=True)


def test_trainer_two_updates_from_rlds_with_paraphrase(bridge_dirs, tmp_path, monkeypatch):
    import torch

    from intact_tpu_torch import run
    from intact_tpu_torch.config import pipeline
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.train.trainer import Trainer

    port_root, _, _ = bridge_dirs
    monkeypatch.setenv("INTACT_STATS_CACHE", str(tmp_path / "stats"))
    monkeypatch.setattr(pipeline, "pi0_config_from_json", lambda d: dataclasses.replace(
        Pi0Config.tiny(), train_expert_only=bool(d.get("train_expert_only", False))))
    table = tmp_path / "para.json"
    table.write_text(json.dumps({INSTRUCTIONS[0]: ["place the carrot onto the plate"]}))
    kw = {"mesh.fsdp": 1, "per_device_batch_size": 2, "global_batch_size": 4, "n_updates": 2, "log_freq": 1,
          "eval_size": 2, "tokenizer_path": "hash", "log_dir": tmp_path, "data.backend": "rlds",
          "data.train.data_path": port_root, "data.train.shuffle_buffer_size": 16, "data.train.num_parallel_calls": 2,
          "task_paraphrase": "true", "data.paraphrase_json": table}
    argv = ["--config_path", str(REPO / "config/train/pi0_finetune_bridge_expertonly.yaml")]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    cfg = run.build_config(argv)[0]
    trainer = Trainer(cfg, device="cpu")
    assert trainer.train_data.backend == "rlds" and trainer.train_data.rephraser is not None
    losses = []
    real = trainer.train_step

    def step(state, batch):
        out = real(state, batch)
        losses.append(float(out[1]["l2_loss"]))
        return out

    trainer.train_step = step
    trainer.train()
    assert trainer.cnt_update == 2 and len(losses) == 4 and np.isfinite(losses).all()
    assert trainer.train_data.loader_stats.snapshot()["frames"] >= 8
    batch = next(iter(trainer.train_data))
    assert batch["observation"]["image_primary"].dtype == np.uint8
    assert torch.isfinite(trainer.device_batch(batch)["images"]).all()


def test_data_path_imports_nothing_forbidden():
    """With TensorFlow, protobuf, PIL and cv2 unimportable (the card machine
    has none of them), the port writes an RLDS directory and reads batches
    from it through InterleavedDataset(backend="rlds")."""
    script = """
import sys, tempfile, os
for m in ("tensorflow", "tensorflow_datasets", "google.protobuf", "PIL", "cv2", "jax", "intact_tpu"):
    sys.modules[m] = None
import numpy as np
from intact_tpu_torch.config.pipeline import DataConfig
from intact_tpu_torch.data import tfrecord_rlds
from intact_tpu_torch.data.dataset import InterleavedDataset
root = tempfile.mkdtemp()
os.environ["INTACT_STATS_CACHE"] = root
rng = np.random.default_rng(0)
eps = [{"observation": {"image_0": rng.integers(0, 255, (6, 16, 16, 3), dtype=np.uint8),
                        "state": rng.normal(size=(6, 7)).astype(np.float32)},
        "action": rng.normal(size=(6, 7)).astype(np.float32),
        "language_instruction": np.array(["put the spoon on the towel"] * 6)} for _ in range(4)]
tfrecord_rlds.write_rlds_dataset(root, "bridge_dataset", eps, image_encoding="jpeg")
cfg = DataConfig(backend="rlds")
cfg.train.data_path, cfg.train.shuffle_buffer_size, cfg.train.action_horizon = root, 4, 4
batch = next(iter(InterleavedDataset(cfg, 2, image_size=16)))
assert batch["observation"]["image_primary"].shape == (2, 1, 16, 16, 3)
banned = [m for m in sys.modules if m.split(".")[0] in ("tensorflow", "PIL", "cv2", "jax") and sys.modules[m]]
assert not banned, banned
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
