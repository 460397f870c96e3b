"""The port's OXE registry (numpy, no TensorFlow) against the JAX package's
(tf ops, run eagerly on the CPU): every one of the 65 dataset entries'
standardization and canonicalization on the same synthetic raw trajectory,
the named mixes and kwargs, and the geometry and gripper helpers."""

import zlib

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from intact_tpu.data import tf_transforms as jtft  # noqa: E402
from intact_tpu.data.oxe import registry as jreg  # noqa: E402
from intact_tpu_torch.data import tf_transforms as ttft  # noqa: E402
from intact_tpu_torch.data.oxe import registry as treg  # noqa: E402

T = 12
RTOL, ATOL = 1e-6, 1e-6  # float32 within 1e-6 relative (atol for values near 0)


def _strings(values) -> np.ndarray:
    out = np.empty(len(values), object)
    out[:] = list(values)
    return out


def _dict_action(rng, gripper_shape):
    g = rng.choice([-1.0, 0.0, 1.0], size=gripper_shape).astype(np.float32)
    return {"world_vector": rng.normal(size=(T, 3)).astype(np.float32),
            "rotation_delta": rng.normal(size=(T, 3)).astype(np.float32),
            "gripper_closedness_action": g}


# per transform: the raw action, and observation keys that differ from the
# shared layout below (shapes as the transforms read them)
def _action_for(name: str, rng):
    fn = treg.OXE_DATASET_CONFIGS[name]["transform"].__name__
    if fn in ("_rt1", "_kuka", "_jaco_play", "_nyu_door", "_cable_routing"):
        return _dict_action(rng, (T, 1))
    if fn == "_roboturk":
        a = _dict_action(rng, (T, 1))
        a["gripper_closedness_action"] = rng.uniform(-0.2, 1.2, (T, 1)).astype(np.float32)
        return a
    if fn in ("_viola", "_autolab_ur5", "_pusht"):
        return _dict_action(rng, (T,))
    if fn == "_toto":
        a = _dict_action(rng, (T,))
        a["open_gripper"] = rng.integers(0, 2, T).astype(np.int64)
        return a
    if fn == "_bc_z":
        return {"future/xyz_residual": rng.normal(size=(T, 30)).astype(np.float32),
                "future/axis_angle_residual": rng.normal(size=(T, 30)).astype(np.float32),
                "future/target_close": rng.integers(0, 2, (T, 10)).astype(np.int64)}
    if fn == "_rh20t":
        return {"tcp_base": rng.normal(size=(T, 7)).astype(np.float32),
                "gripper": rng.uniform(0, 1, T).astype(np.float32)}
    if fn in ("_taco", "_taco_libero"):
        return {"rel_actions_world": np.concatenate(
            [rng.normal(size=(T, 6)), rng.uniform(-0.2, 1.2, (T, 1))], -1).astype(np.float32)}
    if fn in ("_language_table", "_gnm"):
        return rng.normal(size=(T, 2)).astype(np.float32)
    if fn == "_uiuc_d3field":
        return rng.normal(size=(T, 3)).astype(np.float32)
    a = rng.normal(size=(T, 8)).astype(np.float32)
    q = rng.normal(size=(T, 4))
    a[:, 3:7] = q / np.linalg.norm(q, axis=-1, keepdims=True)  # quaternion slots of the quat datasets
    a[:, -1] = rng.uniform(-0.1, 1.1, T)  # gripper
    if fn == "_mujoco_manip":
        a[:, -1] *= 255.0
    return a


def raw_trajectory(name: str, seed: int = 0) -> dict:
    """A raw episode with every key the dataset's transform reads."""
    rng = np.random.default_rng(seed)
    cfg = treg.OXE_DATASET_CONFIGS[name]
    fn = cfg["transform"].__name__
    obs = {}
    for raw in list(cfg["image_keys"].values()) + list(cfg["depth_keys"].values()):
        if raw is not None:
            obs[raw] = _strings([f"{raw}-{t}".encode() for t in range(T)])

    def f(*shape):
        return rng.normal(size=(T,) + shape).astype(np.float32)

    obs.update({
        "state": f(14), "base_pose_tool_reached": f(7), "gripper_closed": f(1), "robot_obs": f(15),
        "end_effector_cartesian_pos": f(7), "robot_state": f(15), "joint_states": f(7), "gripper_states": f(1),
        "effector_translation": f(2), "ee_position": f(3), "ee_orientation": f(4), "tcp_pose": f(7),
        "present/xyz": f(3), "present/axis_angle": f(3), "present/sensed_close": f(1), "end_effector_pose": f(7),
        "pose": f(7), "gripper": rng.integers(0, 2, T).astype(np.int64), "joint_pos": f(8), "eef_pose": f(7),
        "state_gripper_pose": f(), "tcp_base": f(7), "gripper_width": f(), "position": f(2), "yaw": f(1),
        "natural_language_instruction": _strings([b"pick the can"] * T),
    })
    if fn == "_kuka":  # zlib-compressed float32 fields, one per step
        obs["clip_function_input/base_pose_tool_reached"] = _strings(
            [zlib.compress(f(7)[t].tobytes()) for t in range(T)])
        obs["gripper_closed"] = _strings([zlib.compress(f(1)[t].tobytes()) for t in range(T)])
    if fn == "_libero":
        obs["state"][:, -2:] = rng.choice([0.01, 0.03], size=(T, 2))
    if fn == "_language_table":
        text = np.zeros((T, 16), np.int32)
        for t in range(T):
            codes = [ord(c) for c in f"push block {t}"]
            text[t, :len(codes)] = codes
        obs["instruction"] = text
    return {
        "observation": obs,
        "action": _action_for(name, rng),
        "language_instruction": _strings([b"put the carrot on the plate"] * T),
        "ground_truth_states": {"EE": f(6)},
    }


def to_tf(tree):
    if isinstance(tree, dict):
        return {k: to_tf(v) for k, v in tree.items()}
    return tf.constant(tree)


def assert_tree_close(ours, ref, path=""):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), (path, sorted(ours), sorted(ref))
        for k in ref:
            assert_tree_close(ours[k], ref[k], f"{path}/{k}")
        return
    ref = ref.numpy() if hasattr(ref, "numpy") else np.asarray(ref)
    ours = np.asarray(ours)
    assert ours.shape == ref.shape, (path, ours.shape, ref.shape)
    if ref.dtype == object:
        assert [bytes(x) for x in ours] == [bytes(x) for x in ref.ravel()], path
    else:
        assert ours.dtype == ref.dtype, (path, ours.dtype, ref.dtype)
        np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL, err_msg=path)


@pytest.mark.parametrize("name", sorted(jreg.OXE_DATASET_CONFIGS))
def test_standardize_matches_jax(name):
    raw = raw_trajectory(name)
    cams = ("primary", "secondary", "wrist")
    ref = jreg._canonicalize(to_tf(raw), name=name, cameras=cams, load_depth=True)
    ours = treg._canonicalize(raw, name=name, cameras=cams, load_depth=True)
    assert_tree_close(ours, ref)
    assert ours["action"].dtype == np.float32 and ours["action"].ndim == 2


def test_registry_tables_match_jax():
    assert len(treg.OXE_DATASET_CONFIGS) == len(jreg.OXE_DATASET_CONFIGS) == 65
    for name, j in jreg.OXE_DATASET_CONFIGS.items():
        t = treg.OXE_DATASET_CONFIGS[name]
        assert {k: v for k, v in t.items() if k != "transform"} == {k: v for k, v in j.items() if k != "transform"}
        assert t["transform"].__name__ == j["transform"].__name__
    assert treg.OXE_NAMED_MIXES == jreg.OXE_NAMED_MIXES
    assert treg.ACTION_NORMALIZATION_MASKS == jreg.ACTION_NORMALIZATION_MASKS


@pytest.mark.parametrize("mix", sorted(jreg.OXE_NAMED_MIXES))
def test_mix_kwargs_match_jax(mix):
    jk, jw = jreg.make_oxe_dataset_kwargs_and_weights(mix, "/data", ("primary", "wrist"), load_proprio=False)
    tk, tw = treg.make_oxe_dataset_kwargs_and_weights(mix, "/data", ("primary", "wrist"), load_proprio=False)
    assert tw == jw
    for a, b in zip(tk, jk):
        assert {k: v for k, v in a.items() if k != "standardize_fn"} == {
            k: v for k, v in b.items() if k != "standardize_fn"}
        assert a["standardize_fn"].keywords == b["standardize_fn"].keywords


def test_unknown_mix_and_view_raise():
    with pytest.raises(KeyError, match="Unknown mix"):
        treg.make_oxe_dataset_kwargs_and_weights("nope", "/data")
    with pytest.raises(ValueError, match="unknown camera views"):
        treg.make_oxe_dataset_kwargs("bridge_dataset", "/data", ("left",))


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(treg.quat_xyzw_to_euler(q), jreg.quat_xyzw_to_euler(tf.constant(q)).numpy(),
                               rtol=1e-5, atol=1e-6)
    rpy = rng.uniform(-1.5, 1.5, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(treg.euler_to_axis_angle(rpy), jreg.euler_to_axis_angle(tf.constant(rpy)).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_gripper_transforms_match_jax(seed):
    rng = np.random.default_rng(seed)
    cont = rng.uniform(0, 1, 40).astype(np.float32)
    cont[rng.integers(0, 40, 10)] = rng.choice([0.0, 1.0], 10)
    np.testing.assert_array_equal(ttft.binarize_gripper_actions(cont),
                                  jtft.binarize_gripper_actions_tf(tf.constant(cont)).numpy())
    rel = rng.choice([-1.0, 0.0, 0.0, 1.0], 40).astype(np.float32)
    np.testing.assert_array_equal(ttft.rel2abs_gripper_actions(rel),
                                  jtft.rel2abs_gripper_actions_tf(tf.constant(rel)).numpy())
    np.testing.assert_array_equal(ttft.rel2abs_gripper_actions(np.zeros(5, np.float32)),
                                  jtft.rel2abs_gripper_actions_tf(tf.constant(np.zeros(5, np.float32))).numpy())
    np.testing.assert_array_equal(ttft.invert_gripper_actions(cont),
                                  jtft.invert_gripper_actions_tf(tf.constant(cont)).numpy())
