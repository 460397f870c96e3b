"""Trajectory chunking with pad masks (`chunk_act_obs`, copied from
intact_tpu/data/transforms.py; the gripper relabeling helpers there serve the
RLDS backend, not ported yet).

Numpy reimplementation of the reference semantics
(`src/data/traj_transforms.py:13-103` chunk_act_obs,
`src/data/utils/data_utils.py:303-402` gripper helpers). Used by the
synthetic backend.
"""

from __future__ import annotations

import numpy as np


def chunk_act_obs(traj: dict, window_size: int = 1, action_horizon: int = 1,
                  max_action_future: int | None = None) -> dict:
    """Chunk a trajectory dict into per-timestep observation histories and
    action-future chunks.

    In:  observation/* [T, ...], action [T, dim], optional action_pad_mask
         [T, dim], optional task/timestep goal index.
    Out: observation/* [T, window, ...] (+ timestep_pad_mask), action
         [T, window, horizon, dim], action_pad_mask [T, window, horizon, dim],
         and — when max_action_future is set — future_action
         [T, window, max_action_future, dim] (the reference's
         chunk_act_obs_also_future, `src/data/traj_transforms.py:106-168`:
         a longer action lookahead than the training horizon, repeating the
         last action past the end of the trajectory).

    Edge handling matches the reference: history repeats the first frame;
    action futures repeat the last action; actions past the goal/final
    timestep are marked padding via task_completed.
    """
    action = np.asarray(traj["action"])
    traj_len = action.shape[0]

    hist_idx = np.arange(traj_len)[:, None] + np.arange(-window_size + 1, 1)
    timestep_pad_mask = hist_idx >= 0
    hist_idx = np.maximum(hist_idx, 0)

    obs = {k: np.asarray(v)[hist_idx] for k, v in traj["observation"].items()}
    obs["timestep_pad_mask"] = timestep_pad_mask

    future_action = None
    if max_action_future is not None:
        if action.ndim == 2:
            fut_idx = np.arange(traj_len)[:, None] + np.arange(max_action_future)
            fut_idx = np.minimum(fut_idx, traj_len - 1)
            future_action = action[fut_idx]  # [T, F, dim]
        else:
            future_action = action[:, :max_action_future]
        future_action = future_action[hist_idx]  # [T, window, F, dim]

    if action.ndim == 2:
        chunk_idx = np.arange(traj_len)[:, None] + np.arange(action_horizon)
        chunk_idx = np.minimum(chunk_idx, traj_len - 1)
        action = action[chunk_idx]  # [T, horizon, dim]
    else:
        if action.shape[1] < action_horizon:
            raise ValueError(
                f"action_horizon ({action_horizon}) > pre-chunked dim ({action.shape[1]})"
            )
        action = action[:, :action_horizon]
    action = action[hist_idx]  # [T, window, horizon, dim]

    task = traj.get("task", {})
    goal_timestep = np.asarray(task.get("timestep", np.full(traj_len, traj_len - 1)))

    t, w, h = np.meshgrid(
        np.arange(traj_len), np.arange(window_size), np.arange(action_horizon),
        indexing="ij",
    )
    relative_goal = goal_timestep[:, None, None] - (t - (window_size + 1) + w + h)
    task_completed = relative_goal <= 0
    obs["task_completed"] = task_completed

    pad = np.asarray(traj.get("action_pad_mask", np.ones(action.shape[-1:], bool)))
    if pad.ndim == 1:
        pad = np.broadcast_to(pad, (traj_len, pad.shape[0]))
    if pad.ndim == 2:
        pad = pad[:, None, None, :]
    else:
        pad = pad[:, None, :]
    action_pad_mask = np.logical_and(pad, ~task_completed[:, :, :, None])

    out = dict(traj)
    out["observation"] = obs
    out["action"] = action.astype(np.float32)
    out["action_pad_mask"] = action_pad_mask
    if future_action is not None:
        out["future_action"] = future_action.astype(np.float32)
    return out
