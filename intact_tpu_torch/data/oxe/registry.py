"""OXE dataset registry: schema configs, standardization transforms, mixes
(intact_tpu/data/oxe/registry.py in numpy float32, without TensorFlow).

Every per-dataset transform takes a raw trajectory (nested dict of [T, ...]
numpy arrays, as `tfrecord_rlds.decode_episode` reads it) and returns
`(traj, action, proprio, language)`; `_canonicalize` assembles the canonical
layout

  observation/image_primary [image_secondary, image_wrist],
  observation/proprio, task/language_instruction,
  action [T, d] float32 (EEF: xyz delta, rpy delta, gripper in [0,1], 1=open)

Missing cameras become empty-byte-string padding frames (decoded to zeros
downstream); datasets without proprio get a zeros placeholder. Strings are
object arrays of bytes.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np

from intact_tpu_torch.data.tf_transforms import (
    binarize_gripper_actions,
    invert_gripper_actions,
    rel2abs_gripper_actions,
    tree_map,
)

_F = np.float32

# ---------------------------------------------------------------------------
# encodings -> normalization masks (reference oxe/__init__.py:40-63)
# ---------------------------------------------------------------------------

EEF_POS = "eef_pos"  # xyz delta + rpy delta + gripper
JOINT_POS = "joint_pos"  # 7 joint deltas + gripper
JOINT_POS_BIMANUAL = "joint_pos_bimanual"  # 2 x (6 joints + gripper)
NAV_2D = "nav_2d"  # xy waypoint deltas
JOINT_POS_BIMANUAL_NAV = "joint_pos_bimanual_nav"  # bimanual + base vel

ACTION_NORMALIZATION_MASKS: dict[str, list[bool]] = {
    EEF_POS: [True] * 6 + [False],
    JOINT_POS: [True] * 7 + [False],
    JOINT_POS_BIMANUAL: [True] * 6 + [False] + [True] * 6 + [False],
    NAV_2D: [True] * 2,
    JOINT_POS_BIMANUAL_NAV: [True] * 6 + [False] + [True] * 6 + [False] + [True] * 2,
}


# ---------------------------------------------------------------------------
# helpers (geometry, gripper, trajectory surgery)
# ---------------------------------------------------------------------------

def _f32(x) -> np.ndarray:
    return np.asarray(x, _F)


def _cat(parts, axis=-1) -> np.ndarray:
    return np.concatenate([_f32(p) for p in parts], axis=axis)


def quat_xyzw_to_euler(q) -> np.ndarray:
    """[T, 4] xyzw quaternion -> [T, 3] roll/pitch/yaw (XYZ convention)."""
    x, y, z, w = np.moveaxis(_f32(q), -1, 0)
    one, two = _F(1), _F(2)
    roll = np.arctan2(two * (w * x + y * z), one - two * (x * x + y * y))
    pitch = np.arcsin(np.clip(two * (w * y - z * x), _F(-1), one))
    yaw = np.arctan2(two * (w * z + x * y), one - two * (y * y + z * z))
    return np.stack([roll, pitch, yaw], axis=-1).astype(_F)


def euler_to_axis_angle(rpy) -> np.ndarray:
    """[T, 3] roll/pitch/yaw -> [T, 3] axis * angle (via the quaternion)."""
    r, p, y = np.moveaxis(_f32(rpy) * _F(0.5), -1, 0)
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    yq = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    norm = np.sqrt(np.maximum(x * x + yq * yq + z * z, _F(1e-12)))
    angle = _F(2) * np.arctan2(norm, w)
    axis = np.stack([x, yq, z], axis=-1) / norm[:, None]
    return (axis * angle[:, None]).astype(_F)


def _relabel_eef_actions(traj):
    """xyz/rpy actions recomputed as reached-state deltas; drops the last step."""
    state = _f32(traj["observation"]["state"])
    movement = state[1:, :6] - state[:-1, :6]
    out = tree_map(lambda x: x[:-1], traj)
    out["action"] = _cat([movement, _f32(traj["action"])[:-1, -1:]], axis=1)
    return out


def _every_nth(traj, n: int):
    return tree_map(lambda x: x[::n], traj)


def _rel2abs(g):
    """Relative gripper CLOSEDNESS (+1 = closing, the RT-1 family's) ->
    absolute [0, 1] (1 = open): negated into the helper's +1 = open."""
    return rel2abs_gripper_actions(-_f32(g))


def _binarize(g):
    return binarize_gripper_actions(g)


def _invert(g):
    return invert_gripper_actions(g)


def _clip01(g):
    return np.clip(_f32(g), _F(0), _F(1))


def _nat_lang(traj):
    """observation/natural_language_instruction (RT-X family layout)."""
    return traj["observation"]["natural_language_instruction"]


BLANK = object()  # sentinel: dataset has no informative language


def _blank(n: int) -> np.ndarray:
    out = np.empty(n, object)
    out[:] = [b""] * n
    return out


# ---------------------------------------------------------------------------
# per-dataset transforms: traj -> (traj, action, proprio|None, language|None)
# language None -> traj["language_instruction"]; BLANK -> ""
# ---------------------------------------------------------------------------

def _bridge(traj):
    a = _f32(traj["action"])
    traj["action"] = _cat([a[:, :6], _binarize(a[:, -1])[:, None]], axis=1)
    traj = _relabel_eef_actions(traj)
    return traj, traj["action"], traj["observation"]["state"], None


def _rt1(traj):
    act = traj["action"]
    g = _rel2abs(_f32(act["gripper_closedness_action"])[:, 0])
    action = _cat([act["world_vector"], act["rotation_delta"], g[:, None]])
    proprio = _cat([traj["observation"]["base_pose_tool_reached"], traj["observation"]["gripper_closed"]])
    return traj, action, proprio, _nat_lang(traj)


def _zlib_floats(vals) -> np.ndarray:
    return np.concatenate([np.frombuffer(zlib.decompress(bytes(v)), "<f4") for v in vals]).astype(_F)


def _kuka(traj):
    act = traj["action"]
    g = _rel2abs(_f32(act["gripper_closedness_action"])[:, 0])
    action = _cat([act["world_vector"], act["rotation_delta"], g[:, None]])
    eef = _zlib_floats(traj["observation"]["clip_function_input/base_pose_tool_reached"])
    grip = _zlib_floats(traj["observation"]["gripper_closed"])
    proprio = _cat([eef.reshape(-1, 7), grip.reshape(-1, 1)])
    return traj, action, proprio, BLANK


def _taco(traj):
    act = _f32(traj["action"]["rel_actions_world"])
    action = _cat([act[:, :6], _clip01(act[:, -1:])])
    robs = _f32(traj["observation"]["robot_obs"])
    proprio = _cat([robs[:, :6], robs[:, -1:]])
    return traj, action, proprio, _nat_lang(traj)


def _taco_libero(traj):
    """taco_play in libero action/state form: ypr euler -> axis-angle,
    gripper flipped to +1=close/-1=open."""
    act = _f32(traj["action"]["rel_actions_world"])
    aa = euler_to_axis_angle(act[:, 3:6][:, [2, 1, 0]])  # ypr -> rpy
    g = _F(1) - _F(2) * _clip01(act[:, -1:])
    action = _cat([act[:, :3], aa, g])
    robs = _f32(traj["observation"]["robot_obs"])
    proprio = _cat([robs[:, :3], euler_to_axis_angle(robs[:, 3:6][:, [2, 1, 0]]), -robs[:, -1:]])
    return traj, action, proprio, _nat_lang(traj)


def _libero(traj):
    action = _f32(traj["action"])[:, :7]
    state = _f32(traj["observation"]["state"])
    closed = np.min(np.abs(state[:, -2:]), axis=1) < _F(0.015)
    g1 = np.where(closed, _F(1), _F(-1))[:, None]
    return traj, action, _cat([state[:, :6], g1]), None


def _jaco_play(traj):
    act = traj["action"]
    g = _rel2abs(_f32(act["gripper_closedness_action"])[:, 0])
    wv = _f32(act["world_vector"])
    action = _cat([wv, np.zeros_like(wv), g[:, None]])
    return traj, action, traj["observation"]["end_effector_cartesian_pos"], _nat_lang(traj)


def _cable_routing(traj):
    act = traj["action"]
    wv = _f32(act["world_vector"])
    action = _cat([wv, act["rotation_delta"], np.zeros_like(wv[:, :1])])
    return traj, action, traj["observation"]["robot_state"], BLANK


def _roboturk(traj):
    act = traj["action"]
    g = _invert(_clip01(act["gripper_closedness_action"]))
    action = _cat([act["world_vector"], act["rotation_delta"], g])
    return traj, action, None, BLANK


def _nyu_door(traj):
    act = traj["action"]
    g = _rel2abs(_f32(act["gripper_closedness_action"])[:, 0])
    action = _cat([act["world_vector"], act["rotation_delta"], g[:, None]])
    return traj, action, None, BLANK


def _viola(traj):
    act = traj["action"]
    g = _invert(_clip01(_f32(act["gripper_closedness_action"])[:, None]))
    action = _cat([act["world_vector"], act["rotation_delta"], g])
    proprio = _cat([traj["observation"]["joint_states"], traj["observation"]["gripper_states"]])
    return traj, action, proprio, BLANK


def _autolab_ur5(traj):
    act = traj["action"]
    g = _rel2abs(act["gripper_closedness_action"])
    action = _cat([act["world_vector"], act["rotation_delta"], g[:, None]])
    return traj, action, _f32(traj["observation"]["robot_state"])[:, 6:14], _nat_lang(traj)


def _toto(traj):
    act = traj["action"]
    action = _cat([act["world_vector"], act["rotation_delta"], _f32(act["open_gripper"])[:, None]])
    return traj, action, traj["observation"]["state"], BLANK


def _language_table(traj):
    a = _f32(traj["action"])
    action = _cat([a, np.zeros_like(a), np.zeros_like(a), np.ones_like(a[:, :1])])
    # instructions are padded unicode codepoints -> strings (up to the first NUL)
    lang = np.empty(len(traj["observation"]["instruction"]), object)
    lang[:] = ["".join(map(chr, row)).split("\x00")[0].encode() for row in
               np.asarray(traj["observation"]["instruction"])]
    return traj, action, traj["observation"]["effector_translation"], lang


def _pusht(traj):
    act = traj["action"]
    action = _cat([act["world_vector"], act["rotation_delta"], _f32(act["gripper_closedness_action"])[:, None]])
    return traj, action, traj["observation"]["robot_state"], _nat_lang(traj)


def _stanford_kuka_mm(traj):
    a = _f32(traj["action"])
    action = _cat([a[:, :3], np.zeros_like(a[:, :3]), a[:, -1:]])
    proprio = _cat([traj["observation"]["ee_position"], traj["observation"]["ee_orientation"]])
    return traj, action, proprio, None


def _nyu_rot(traj):
    return traj, _f32(traj["action"])[..., :7], traj["observation"]["state"], None


def _stanford_hydra(traj):
    a = _f32(traj["action"])
    action = _cat([a[:, :6], _invert(a[:, -1:])])
    s = _f32(traj["observation"]["state"])
    return traj, action, _cat([s[:, :3], s[:, 7:10], s[:, -3:-2]]), BLANK


def _invert_clip_gripper_tail(traj, proprio_fn, language=BLANK):
    """shared shape: action[:6] + inverted clipped gripper."""
    a = _f32(traj["action"])
    action = _cat([a[:, :6], _invert(_clip01(a[:, -1:]))])
    return traj, action, proprio_fn(traj), language


def _austin_buds(traj):
    return _invert_clip_gripper_tail(traj, lambda t: _f32(t["observation"]["state"])[:, :8])


def _nyu_franka_play(traj):
    a = _f32(traj["action"])
    action = _cat([a[:, -8:-2], _clip01(a[:, -2:-1])])
    return traj, action, _f32(traj["observation"]["state"])[:, -6:], BLANK


def _maniskill(traj):
    proprio = _cat([traj["observation"]["tcp_pose"], _f32(traj["observation"]["state"])[:, 7:8]])
    return traj, traj["action"], proprio, None


def _furniture_bench(traj):
    a = _f32(traj["action"])
    action = _cat([a[:, :3], quat_xyzw_to_euler(a[:, 3:7]), _invert(_clip01(a[:, -1:]))])
    s = _f32(traj["observation"]["state"])
    return traj, action, _cat([s[:, :7], s[:, -1:]]), None


def _cmu_franka_exploration(traj):
    return traj, _f32(traj["action"])[..., :-1], None, None


def _ucsd_kitchen(traj):
    return traj, _f32(traj["action"])[..., :-1], _f32(traj["observation"]["state"])[:, :7], None


def _ucsd_pick_place(traj):
    a = _f32(traj["action"])
    action = _cat([a[:, :3], np.zeros_like(a[:, :3]), a[:, -1:]])
    return traj, action, traj["observation"]["state"], None


def _austin_sailor(traj):
    return _invert_clip_gripper_tail(traj, lambda t: t["observation"]["state"])


def _austin_sirius(traj):
    return _invert_clip_gripper_tail(traj, lambda t: t["observation"]["state"])


def _bc_z(traj):
    act = traj["action"]
    action = _cat([_f32(act["future/xyz_residual"])[:, :3], _f32(act["future/axis_angle_residual"])[:, :3],
                   _invert(_f32(act["future/target_close"])[:, :1])])
    obs = traj["observation"]
    proprio = _cat([obs["present/xyz"], obs["present/axis_angle"], obs["present/sensed_close"]])
    return traj, action, proprio, _nat_lang(traj)


def _utokyo_pr2(traj):
    return traj, _f32(traj["action"])[..., :-1], traj["observation"]["state"], None


def _utokyo_xarm_pick_place(traj):
    return traj, traj["action"], None, None


def _utokyo_xarm_bimanual(traj):
    return traj, _f32(traj["action"])[..., -7:], traj["observation"]["end_effector_pose"], None


def _robo_net(traj):
    a = _f32(traj["action"])
    action = _cat([a[:, :4], np.zeros_like(a[:, :2]), a[:, -1:]])
    s = _f32(traj["observation"]["state"])
    return traj, action, _cat([s[:, :4], np.zeros_like(s[:, :2]), s[:, -1:]]), None


def _berkeley_mvp(traj):
    a = _f32(traj["action"])
    action = _cat([a[:, :-1], _invert(a[:, -1:])], axis=1)
    proprio = _cat([traj["observation"]["pose"], _f32(traj["observation"]["gripper"])[:, None]])
    return traj, action, proprio, None


def _berkeley_rpt(traj):
    """30Hz -> 10Hz subsample, joint-delta actions recomputed."""
    traj = _every_nth(traj, 3)
    joints = _f32(traj["observation"]["joint_pos"])
    out = tree_map(lambda x: x[:-1], traj)
    out["action"] = _cat([joints[1:, :7] - joints[:-1, :7], _invert(_f32(traj["action"])[:-1, -1:])], axis=1)
    proprio = _cat([out["observation"]["joint_pos"], _f32(out["observation"]["gripper"])[:, None]])
    return out, out["action"], proprio, None


def _kaist(traj):
    a = _f32(traj["action"])
    action = _cat([a[:, :6], np.zeros_like(a[:, :1])])
    return traj, action, _f32(traj["observation"]["state"])[:, -7:], None


def _stanford_mask_vit(traj):
    a = _f32(traj["action"])
    action = _cat([a[:, :4], np.zeros_like(a[:, :2]), a[:, -1:]])
    e = _f32(traj["observation"]["end_effector_pose"])
    return traj, action, _cat([e[:, :4], np.zeros_like(e[:, :2]), e[:, -1:]]), None


def _tokyo_lsmo(traj):
    s = _f32(traj["observation"]["state"])
    return traj, traj["action"], _cat([s[:, :6], s[:, -1:]]), None


def _dlr_sara_pour(traj):
    return traj, traj["action"], traj["observation"]["state"], None


def _dlr_sara_grid_clamp(traj):
    return traj, traj["action"], _f32(traj["observation"]["state"])[:, :6], None


def _dlr_edan(traj):
    a = _f32(traj["action"])
    return traj, _cat([a[:, :6], _invert(a[:, -1:])]), traj["observation"]["state"], None


def _asu_table_top(traj):
    proprio = _cat([traj["ground_truth_states"]["EE"], _f32(traj["observation"]["state"])[:, -1:]])
    return traj, traj["action"], proprio, None


def _robocook(traj):
    return traj, traj["action"], traj["observation"]["state"], None


def _imperial_wristcam(traj):
    return traj, _f32(traj["action"])[..., :-1], None, None


def _iamlab_pick_insert(traj):
    a = _f32(traj["action"])
    action = _cat([a[:, :3], quat_xyzw_to_euler(a[:, 3:7]), a[:, 7:8]])
    s = _f32(traj["observation"]["state"])
    return traj, action, _cat([s[:, :7], s[:, 7:8]]), None


def _uiuc_d3field(traj):
    a = _f32(traj["action"])
    return traj, _cat([a, np.zeros_like(a), np.zeros_like(a[:, :1])]), None, None


def _utaustin_mutex(traj):
    return _invert_clip_gripper_tail(traj, lambda t: _f32(t["observation"]["state"])[:, :8])


def _berkeley_fanuc(traj):
    s = _f32(traj["observation"]["state"])
    action = _cat([traj["action"], _invert(s[:, 6:7])])
    return traj, action, _cat([s[:, :6], s[:, 6:7]]), None


def _cmu_food(traj):
    a = _f32(traj["action"])
    action = _cat([a[:, :3], quat_xyzw_to_euler(a[:, 3:7]), a[:, -1:]])
    return traj, action, traj["observation"]["state"], None


def _playfusion(traj):
    a = _f32(traj["action"])
    return traj, _cat([a[:, :3], a[:, -4:]]), traj["observation"]["state"], None


def _cmu_stretch(traj):
    s = _f32(traj["observation"]["state"])
    proprio = _cat([s[:, :3], np.zeros_like(s[:, :3]), s[:, -1:]])
    return traj, _f32(traj["action"])[..., :-1], proprio, None


def _gnm(traj):
    """Navigation: subsample x3, recompute local-frame xy waypoints."""
    if len(traj["action"]) > 1:
        a0 = _f32(traj["action"])[0]
        pos0 = _f32(traj["observation"]["position"])
        scale = np.sqrt(np.sum(a0 * a0, dtype=_F)) / np.maximum(
            np.sqrt(np.sum((pos0[1] - pos0[0]) ** 2, dtype=_F)), _F(1e-8))
        t = _every_nth(traj, 3)
        yaw = _f32(t["observation"]["yaw"]).reshape(len(t["action"]))
        pos = _f32(t["observation"]["position"])
        cos, sin = np.cos(yaw), np.sin(yaw)
        delta = pos[1:] - pos[:-1]
        # delta[t] @ [[cos, -sin], [sin, cos]]
        action = np.stack([delta[:, 0] * cos[:-1] + delta[:, 1] * sin[:-1],
                           delta[:, 0] * -sin[:-1] + delta[:, 1] * cos[:-1]], axis=-1) * scale
        t = tree_map(lambda x: x[:-1], t)
        t["action"] = action.astype(_F)
        traj = t
    else:
        traj = tree_map(lambda x: x[:0], traj)
    yaw = _f32(traj["observation"]["yaw"])
    proprio = _cat([traj["observation"]["position"], yaw[..., None] if yaw.ndim == 1 else yaw])
    return traj, traj["action"], proprio, None


def _aloha(traj):
    traj = _every_nth(traj, 5)  # 50Hz -> 10Hz
    return traj, traj["action"], traj["observation"]["state"], None


def _fmb(traj):
    proprio = _cat([traj["observation"]["eef_pose"], _f32(traj["observation"]["state_gripper_pose"])[..., None]])
    return traj, traj["action"], proprio, None


def _dobbe(traj):
    return traj, traj["action"], traj["observation"]["state"], None


def _roboset(traj):
    a = _f32(traj["action"])
    return traj, _cat([a[:, :7], _invert(_clip01(a[:, -1:]))]), traj["observation"]["state"], None


def _rh20t(traj):
    act = traj["action"]
    action = _cat([act["tcp_base"], _f32(act["gripper"])[:, None]])
    proprio = _cat([traj["observation"]["tcp_base"], _f32(traj["observation"]["gripper_width"])[..., None]])
    return traj, action, proprio, None


def _mujoco_manip(traj):
    a = _f32(traj["action"])
    return traj, _cat([a[:, :6], _invert(a[:, -1:] / _F(255.0))]), None, None


# ---------------------------------------------------------------------------
# dataset configs: {name: (image_keys, action_encoding, transform)}
# image_keys maps view -> raw observation key (None = view unavailable)
# ---------------------------------------------------------------------------

def _entry(primary=None, secondary=None, wrist=None, enc=EEF_POS, transform=None,
           lang=True, depth=None, depth_secondary=None, depth_wrist=None):
    """lang=False marks datasets whose transform BLANKs uninformative
    language — the unlabeled filter must not apply to them (it would drop
    every episode). depth*/depth_wrist mirror the reference's
    depth_obs_keys (`src/data/oxe/oxe_dataset_configs.py:42-`): raw
    observation keys for per-view depth, None where the view has none."""
    return {
        "image_keys": {"primary": primary, "secondary": secondary, "wrist": wrist},
        "depth_keys": {"primary": depth, "secondary": depth_secondary,
                       "wrist": depth_wrist},
        "action_encoding": enc,
        "transform": transform,
        "action_normalization_mask": ACTION_NORMALIZATION_MASKS[enc],
        "has_language": lang,
    }


_E = _entry
OXE_DATASET_CONFIGS: dict[str, dict] = {
    "fractal20220817_data": _E("image", transform=_rt1),
    "fractal_euler": _E("image", transform=_rt1),
    "kuka": _E("image", transform=_kuka, lang=False),
    "bridge_dataset": _E("image_0", secondary="image_1", transform=_bridge),
    "taco_play": _E("rgb_static", wrist="rgb_gripper", transform=_taco,
                    depth="depth_static", depth_wrist="depth_gripper"),
    "taco_play_libero": _E("rgb_static", wrist="rgb_gripper", transform=_taco_libero,
                           depth="depth_static", depth_wrist="depth_gripper"),
    "libero_spatial": _E("image", wrist="wrist_image", transform=_libero),
    "libero_object": _E("image", wrist="wrist_image", transform=_libero),
    "libero_goal": _E("image", wrist="wrist_image", transform=_libero),
    "libero_10": _E("image", wrist="wrist_image", transform=_libero),
    "libero_90": _E("image", wrist="wrist_image", transform=_libero),
    "jaco_play": _E("image", wrist="image_wrist", transform=_jaco_play),
    "berkeley_cable_routing": _E(
        "image", secondary="top_image", wrist="wrist45_image", transform=_cable_routing
    , lang=False),
    "roboturk": _E("front_rgb", transform=_roboturk, lang=False),
    "nyu_door_opening_surprising_effectiveness": _E(wrist="image", transform=_nyu_door, lang=False),
    "viola": _E("agentview_rgb", wrist="eye_in_hand_rgb", transform=_viola, lang=False),
    "berkeley_autolab_ur5": _E("image", wrist="hand_image", transform=_autolab_ur5,
                               depth="depth"),
    "toto": _E("image", transform=_toto, lang=False),
    "language_table": _E("rgb", transform=_language_table),
    "columbia_cairlab_pusht_real": _E("image", wrist="wrist_image", transform=_pusht),
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": _E(
        "image", transform=_stanford_kuka_mm, depth="depth_image"
    ),
    "nyu_rot_dataset_converted_externally_to_rlds": _E("image", transform=_nyu_rot),
    "stanford_hydra_dataset_converted_externally_to_rlds": _E(
        "image", wrist="wrist_image", transform=_stanford_hydra
    , lang=False),
    "austin_buds_dataset_converted_externally_to_rlds": _E(
        "image", wrist="wrist_image", transform=_austin_buds
    , lang=False),
    "nyu_franka_play_dataset_converted_externally_to_rlds": _E(
        "image", secondary="image_additional_view", transform=_nyu_franka_play,
        depth="depth", depth_secondary="depth_additional_view", lang=False),
    "maniskill_dataset_converted_externally_to_rlds": _E(
        "image", wrist="wrist_image", transform=_maniskill,
        depth="depth", depth_wrist="wrist_depth"
    ),
    "furniture_bench_dataset_converted_externally_to_rlds": _E(
        "image", wrist="wrist_image", transform=_furniture_bench
    ),
    "cmu_franka_exploration_dataset_converted_externally_to_rlds": _E(
        "highres_image", transform=_cmu_franka_exploration
    ),
    "ucsd_kitchen_dataset_converted_externally_to_rlds": _E(
        "image", transform=_ucsd_kitchen
    ),
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": _E(
        "image", transform=_ucsd_pick_place
    ),
    "austin_sailor_dataset_converted_externally_to_rlds": _E(
        "image", wrist="wrist_image", transform=_austin_sailor
    , lang=False),
    "austin_sirius_dataset_converted_externally_to_rlds": _E(
        "image", wrist="wrist_image", transform=_austin_sirius
    , lang=False),
    "bc_z": _E("image", transform=_bc_z),
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": _E(
        "image", transform=_utokyo_pr2
    ),
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": _E(
        "image", transform=_utokyo_pr2
    ),
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": _E(
        "image", secondary="image2", wrist="hand_image",
        transform=_utokyo_xarm_pick_place,
    ),
    "utokyo_xarm_bimanual_converted_externally_to_rlds": _E(
        "image", transform=_utokyo_xarm_bimanual
    ),
    "robo_net": _E("image", secondary="image1", transform=_robo_net),
    "berkeley_mvp_converted_externally_to_rlds": _E(
        wrist="hand_image", enc=JOINT_POS, transform=_berkeley_mvp
    ),
    "berkeley_rpt_converted_externally_to_rlds": _E(
        wrist="hand_image", enc=JOINT_POS, transform=_berkeley_rpt
    ),
    "kaist_nonprehensile_converted_externally_to_rlds": _E("image", transform=_kaist),
    "stanford_mask_vit_converted_externally_to_rlds": _E(
        "image", transform=_stanford_mask_vit
    ),
    "tokyo_u_lsmo_converted_externally_to_rlds": _E("image", transform=_tokyo_lsmo),
    "dlr_sara_pour_converted_externally_to_rlds": _E("image", transform=_dlr_sara_pour),
    "dlr_sara_grid_clamp_converted_externally_to_rlds": _E(
        "image", transform=_dlr_sara_grid_clamp
    ),
    "dlr_edan_shared_control_converted_externally_to_rlds": _E(
        "image", transform=_dlr_edan
    ),
    "asu_table_top_converted_externally_to_rlds": _E("image", transform=_asu_table_top),
    "stanford_robocook_converted_externally_to_rlds": _E(
        "image_1", secondary="image_2", transform=_robocook,
        depth="depth_1", depth_secondary="depth_2"
    ),
    "imperialcollege_sawyer_wrist_cam": _E(
        "image", wrist="wrist_image", transform=_imperial_wristcam
    ),
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": _E(
        "image", wrist="wrist_image", transform=_iamlab_pick_insert
    ),
    "uiuc_d3field": _E("image_1", secondary="image_2", transform=_uiuc_d3field,
                       depth="depth_1", depth_secondary="depth_2"),
    "utaustin_mutex": _E("image", wrist="wrist_image", transform=_utaustin_mutex, lang=False),
    "berkeley_fanuc_manipulation": _E(
        "image", wrist="wrist_image", transform=_berkeley_fanuc
    ),
    "cmu_playing_with_food": _E(
        "image", wrist="finger_vision_1", transform=_cmu_food
    ),
    "cmu_play_fusion": _E("image", transform=_playfusion),
    "cmu_stretch": _E("image", transform=_cmu_stretch),
    "gnm_dataset": _E("image", enc=NAV_2D, transform=_gnm),
    "aloha_static_dataset": _E(
        "cam_high", secondary="cam_low", wrist="cam_right_wrist",
        enc=JOINT_POS_BIMANUAL, transform=_aloha,
    ),
    "aloha_dagger_dataset": _E(
        "cam_high", secondary="cam_low", wrist="cam_right_wrist",
        enc=JOINT_POS_BIMANUAL, transform=_aloha,
    ),
    "aloha_mobile_dataset": _E(
        "cam_high", wrist="cam_right_wrist",
        enc=JOINT_POS_BIMANUAL_NAV, transform=_aloha,
    ),
    "fmb_dataset": _E(
        "image_side_1", secondary="image_side_2", wrist="image_wrist_1", transform=_fmb,
        depth="image_side_1_depth", depth_secondary="image_side_2_depth",
        depth_wrist="image_wrist_1_depth"
    ),
    "dobbe": _E(wrist="wrist_image", transform=_dobbe),
    "roboset": _E(
        "image_left", secondary="image_right", wrist="image_wrist",
        enc=JOINT_POS, transform=_roboset,
    ),
    "rh20t": _E(
        "image_front", secondary="image_side_right", wrist="image_wrist",
        transform=_rh20t,
    ),
    "mujoco_manip": _E("image", transform=_mujoco_manip),
}


# ---------------------------------------------------------------------------
# canonicalization wrapper
# ---------------------------------------------------------------------------

def _canonicalize(traj, *, name: str, cameras: tuple[str, ...], load_depth: bool = False):
    """Run the per-dataset transform, then assemble the canonical layout."""
    entry = OXE_DATASET_CONFIGS[name]
    traj, action, proprio, language = entry["transform"](dict(traj))
    n = len(action)
    obs = {}
    for cam in cameras:
        raw = entry["image_keys"].get(cam)
        key = "image_primary" if cam == "primary" else f"image_{cam}"
        # a view without a camera: empty byte strings, decoded to zero frames
        obs[key] = traj["observation"][raw] if raw is not None else _blank(n)
        if load_depth:
            # raw per-view depth under depth_<view> (encoded bytes pass
            # through, numeric depth as float32); a view without depth gets a
            # [T, 1, 1, 1] zeros placeholder
            draw = entry.get("depth_keys", {}).get(cam)
            if draw is not None:
                d = traj["observation"][draw]
                obs[f"depth_{cam}"] = d if np.asarray(d).dtype == object else _f32(d)
            else:
                obs[f"depth_{cam}"] = np.zeros((n, 1, 1, 1), _F)
    obs["proprio"] = np.zeros((n, 1), _F) if proprio is None else _f32(proprio)
    if language is BLANK:
        language = _blank(n)
    elif language is None:
        language = traj.get("language_instruction", _blank(n))
    return {"observation": obs, "task": {"language_instruction": language}, "action": _f32(action)}


# ---------------------------------------------------------------------------
# named mixes (reference oxe_dataset_mixes.py)
# ---------------------------------------------------------------------------

BRIDGE_MIX = [("bridge_dataset", 1.0)]
FRACTAL_MIX = [("fractal20220817_data", 1.0)]
FRACTAL_EULER_MIX = [("fractal_euler", 1.0)]
TACO_MIX = [("taco_play", 1.0)]
TACO_LIBERO_MIX = [("taco_play_libero", 1.0)]
OXE_SIMPLE = [("fractal_euler", 1.0), ("bridge_dataset", 1.0)]
LIBERO_MIX = [
    ("libero_10", 1.0), ("libero_90", 1.0), ("libero_goal", 1.0),
    ("libero_object", 1.0), ("libero_spatial", 1.0),
]
RT_X_MIX = [
    ("fractal20220817_data", 0.54087122203),
    ("kuka", 0.8341046294),
    ("bridge_dataset", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 2.0),
    ("berkeley_cable_routing", 3.0),
    ("roboturk", 1.0),
    ("nyu_door_opening_surprising_effectiveness", 5.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 1.0),
    ("toto", 1.0),
]
OXE_FRANKA_MIX = [
    ("taco_play", 1.0),
    ("berkeley_cable_routing", 1.0),
    ("viola", 1.0),
    ("toto", 1.0),
    ("stanford_hydra_dataset_converted_externally_to_rlds", 1.0),
    ("austin_buds_dataset_converted_externally_to_rlds", 3.0),
    ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
    ("maniskill_dataset_converted_externally_to_rlds", 0.1),
    ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
    ("cmu_franka_exploration_dataset_converted_externally_to_rlds", 5.0),
    ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
    ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
    ("berkeley_rpt_converted_externally_to_rlds", 1.0),
    ("kaist_nonprehensile_converted_externally_to_rlds", 3.0),
    ("stanford_robocook_converted_externally_to_rlds", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
    ("utaustin_mutex", 1.0),
    ("cmu_play_fusion", 1.0),
]
OXE_MAGIC_SOUP = [
    ("fractal20220817_data", 0.54087122203),
    ("kuka", 0.8341046294),
    ("bridge_dataset", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 1.0),
    ("berkeley_cable_routing", 1.0),
    ("roboturk", 2.0),
    ("nyu_door_opening_surprising_effectiveness", 1.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 2.0),
    ("toto", 1.0),
    ("language_table", 0.1),
    ("stanford_hydra_dataset_converted_externally_to_rlds", 2.0),
    ("austin_buds_dataset_converted_externally_to_rlds", 1.0),
    ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
    ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
    ("ucsd_kitchen_dataset_converted_externally_to_rlds", 2.0),
    ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
    ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
    ("bc_z", 0.2),
    ("dlr_edan_shared_control_converted_externally_to_rlds", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
    ("utaustin_mutex", 1.0),
    ("berkeley_fanuc_manipulation", 2.0),
    ("cmu_stretch", 1.0),
]
OXE_FLEX_ACT_SOUP = OXE_MAGIC_SOUP[:20] + [
    ("berkeley_mvp_converted_externally_to_rlds", 1.0),
    ("dlr_edan_shared_control_converted_externally_to_rlds", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
    ("utaustin_mutex", 1.0),
    ("berkeley_fanuc_manipulation", 2.0),
    ("cmu_stretch", 1.0),
    ("gnm_dataset", 1.0),
    ("aloha_static_dataset", 3.0),
    ("aloha_mobile_dataset", 2.0),
    ("dobbe", 1.0),
    ("roboset", 0.5),
    ("rh20t", 0.5),
]
OXE_FULL_MIX = [
    (name, 1.0) for name in OXE_DATASET_CONFIGS
    if name not in ("fractal_euler", "taco_play_libero", "mujoco_manip",
                    "libero_10", "libero_90", "libero_goal", "libero_object",
                    "libero_spatial", "aloha_static_dataset",
                    "aloha_dagger_dataset", "aloha_mobile_dataset",
                    "fmb_dataset", "dobbe", "roboset", "rh20t")
]

OXE_NAMED_MIXES: dict[str, list[tuple[str, float]]] = {
    "bridge": BRIDGE_MIX,
    "fractal": FRACTAL_MIX,
    "fractal_euler": FRACTAL_EULER_MIX,
    "taco": TACO_MIX,
    "taco_libero": TACO_LIBERO_MIX,
    "rtx": RT_X_MIX,
    "rtx_franka": RT_X_MIX + OXE_FRANKA_MIX,
    "oxe_magic_soup": OXE_MAGIC_SOUP,
    "oxe_flex_act_soup": OXE_FLEX_ACT_SOUP,
    "oxe_simple": OXE_SIMPLE,
    "libero": LIBERO_MIX,
    "oxe_full": OXE_FULL_MIX,
    "bridge_fractal": [("bridge_dataset", 1.0), ("fractal20220817_data", 1.0)],
}


# ---------------------------------------------------------------------------
# kwargs builder (reference oxe/__init__.py:14-140)
# ---------------------------------------------------------------------------

def make_oxe_dataset_kwargs(
    name: str,
    data_dir: str,
    load_camera_views: tuple[str, ...] = ("primary",),
    load_proprio: bool = True,
    load_depth: bool = False,
) -> dict:
    if name not in OXE_DATASET_CONFIGS:
        raise KeyError(
            f"Unknown OXE dataset {name!r}; available: {sorted(OXE_DATASET_CONFIGS)}"
        )
    cfg = OXE_DATASET_CONFIGS[name]
    # a requested view whose raw key is None becomes a padding camera
    # (reference: image_obs_keys values of None synthesize padding images);
    # only a view NAME outside the primary/secondary/wrist scheme is an error
    unknown = set(load_camera_views) - set(cfg["image_keys"])
    if unknown:
        raise ValueError(f"{name}: unknown camera views {sorted(unknown)}")
    return {
        "name": name,
        "data_dir": data_dir,
        "standardize_fn": functools.partial(
            _canonicalize, name=name, cameras=tuple(load_camera_views),
            load_depth=load_depth,
        ),
        "load_proprio": load_proprio,
        "action_normalization_mask": list(cfg["action_normalization_mask"]),
        # blank-language datasets must not hit the unlabeled filter
        "skip_unlabeled": cfg.get("has_language", True),
    }


def make_oxe_dataset_kwargs_and_weights(
    mix_name: str,
    data_dir: str,
    load_camera_views: tuple[str, ...] = ("primary",),
    load_proprio: bool = True,
    load_depth: bool = False,
) -> tuple[list[dict], list[float]]:
    """Named mix -> (per-dataset kwargs for make_dataset_from_rlds, weights)."""
    if mix_name in OXE_NAMED_MIXES:
        entries = OXE_NAMED_MIXES[mix_name]
    elif mix_name in OXE_DATASET_CONFIGS:
        entries = [(mix_name, 1.0)]
    else:
        raise KeyError(
            f"Unknown mix {mix_name!r}; available: {sorted(OXE_NAMED_MIXES)}"
        )
    # dedup repeated entries (concatenated mixes like rtx_franka list
    # taco_play/viola/toto twice): keep the FIRST weight, like the
    # reference's filter_datasets dedup — a duplicate would build two full
    # pipelines for the same data and double-count its transitions
    seen: set[str] = set()
    kwargs_list, weights = [], []
    for name, weight in entries:
        if name in seen:
            import logging

            logging.getLogger("intact_tpu_torch.oxe").warning(
                "mix %r lists %s more than once; keeping the first weight",
                mix_name, name,
            )
            continue
        seen.add(name)
        kwargs_list.append(
            make_oxe_dataset_kwargs(name, data_dir, load_camera_views,
                                    load_proprio, load_depth)
        )
        weights.append(weight)
    return kwargs_list, weights


def register_dataset(name: str, config: dict) -> None:
    OXE_DATASET_CONFIGS[name] = config


def register_mix(name: str, entries: list[tuple[str, float]]) -> None:
    OXE_NAMED_MIXES[name] = entries
