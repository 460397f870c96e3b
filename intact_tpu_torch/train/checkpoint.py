"""Checkpoints in a torch format, with the reference's directory contract.

<ckpt_root>/step_{n}/ per save (n = the gradient-update count), holding
`params.pt` (the parameter tree flattened to {"a/b/c": tensor} on the host,
written with torch.save), for a training state `train_state.pt` (every field
of the state but its params: the optimizer state with its moments,
accumulator and counts, the micro-step or update count, the seed), and
`auxiliary_data.json` (cnt_update and the caller's fields), written last:
its presence is the commit marker, so a crash mid-save leaves a step dir that
restore skips. A root dir resolves to its newest committed step; a step dir
is restored as given.

`restore_train_state` restores params only (resume_run=False) or the whole
state; a params_template/params_transform pair loads a checkpoint whose
parameter tree differs from the live one (float pretrained params into a
quantize_frozen_int8 run), as intact_tpu/train/checkpoint.py does.

Several ranks: a checkpoint holds the one-rank layout, so it restores onto
any world size. `save_from_ranks` gathers each split (`Sharded`) parameter
over its fsdp group one leaf at a time and moves it to rank 0's host, so no
card ever holds the whole tree (the trainer gathers the split optimizer
state the same way); rank 0 clears a stale partial step dir and writes, and
every rank returns behind a barrier once the step is committed.
`restore_train_state` copies only a rank's slice of each split leaf to its
card, and its `localize` cuts the saved fields to a rank's slices.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import shutil
from pathlib import Path

import torch

from intact_tpu_torch.models.common import flatten_paths, unflatten_paths
from intact_tpu_torch.parallel import distributed
from intact_tpu_torch.parallel.sharding import Sharded, gather_leaf, held, take_slice

PARAMS_FILE = "params.pt"
STATE_FILE = "train_state.pt"
AUX_FILE = "auxiliary_data.json"


def step_dir(ckpt_root: str | Path, step: int) -> Path:
    return Path(ckpt_root) / f"step_{step}"


def list_steps(ckpt_root: str | Path, committed_only: bool = False) -> list[int]:
    """Step numbers under the root; `committed_only` keeps the saves whose
    commit marker (auxiliary_data.json) exists."""
    root = Path(ckpt_root)
    if not root.exists():
        return []
    out = []
    for p in root.iterdir():
        if not (p.is_dir() and p.name.startswith("step_")):
            continue
        tail = p.name.split("_", 1)[1]
        if not tail.isdigit():
            continue
        if committed_only and not (p / AUX_FILE).exists():
            continue
        out.append(int(tail))
    return sorted(out)


def _to_host(node):
    if isinstance(node, dict):
        return {k: _to_host(v) for k, v in node.items()}
    return node.detach().to("cpu") if isinstance(node, torch.Tensor) else node


def save_checkpoint(ckpt_root: str | Path, params, step: int, aux: dict | None = None,
                    train_state: dict | None = None) -> Path:
    """Write step_{step}/params.pt, then train_state.pt when a training state
    is given ({field: tensor tree or number}), then auxiliary_data.json as
    the commit marker. A committed step is never overwritten (raises); the
    leftovers of a crash mid-save at this step are cleared first."""
    path = step_dir(ckpt_root, int(step)).resolve()
    if (path / AUX_FILE).exists():
        raise FileExistsError(
            f"{path} already holds a committed checkpoint; refusing to overwrite. Delete the step dir "
            "explicitly (or save under a new checkpoint root) if this is intended.")
    if path.exists() and any(path.iterdir()):
        logging.getLogger("intact_tpu_torch.checkpoint").warning("clearing stale partial step dir %s", path)
        shutil.rmtree(path)
    path.mkdir(parents=True, exist_ok=True)
    host = {k: v.detach().to("cpu") for k, v in flatten_paths(params).items()}
    torch.save(host, path / PARAMS_FILE)
    if train_state is not None:
        torch.save(_to_host(train_state), path / STATE_FILE)
    auxiliary = {"cnt_update": int(step)}
    auxiliary.update(aux or {})
    (path / AUX_FILE).write_text(json.dumps(auxiliary, indent=2))
    return path


def save_from_ranks(ckpt_root: str | Path, params, step: int, aux: dict | None = None,
                    train_state: dict | None = None) -> Path:
    """save_checkpoint from a process group: every rank calls it with its
    params (split leaves as `Sharded` slices) and the same one-rank-layout
    state; the split leaves are gathered leaf by leaf to rank 0's host, rank
    0 clears a stale partial step dir and writes, and every rank returns
    after a barrier, when the step is committed. Without a group it is
    save_checkpoint."""
    path = step_dir(ckpt_root, int(step)).resolve()
    main = distributed.process_index() == 0
    host = {}
    for k, v in flatten_paths(params).items():  # every rank takes part in each split leaf's gather
        leaf = gather_leaf(v.local, v) if isinstance(v, Sharded) else v
        if main:
            host[k] = leaf.detach().to("cpu")
        del leaf
    if main:
        path = save_checkpoint(ckpt_root, host, step, aux=aux, train_state=train_state)
    distributed.barrier()
    return path


def _resolve_latest_step(path: Path) -> Path:
    """Root dir -> newest committed step dir; raises when there is none."""
    steps = list_steps(path, committed_only=True)
    if not steps:
        partial = list_steps(path)
        if partial:
            raise FileNotFoundError(
                f"only uncommitted (crash-truncated?) step dirs under {path}: steps {partial}. Each lacks "
                f"the {AUX_FILE} commit marker; point at a step dir directly to force-restore one.")
        raise FileNotFoundError(f"no checkpoint under {path}")
    return step_dir(path, steps[-1])


def restore_params(ckpt_path: str | Path, template=None) -> dict:
    """The parameter tree of a step dir (or of the newest committed step
    under a root) as host tensors, memory-mapped from the file, so a caller
    can move it to the device leaf by leaf. With a template tree (tensors or
    anything with .shape), every path and shape must match."""
    path = Path(ckpt_path)
    if not (path / PARAMS_FILE).exists():
        path = _resolve_latest_step(path)
    flat = torch.load(path / PARAMS_FILE, map_location="cpu", weights_only=True, mmap=True)
    if template is not None:
        want = flatten_paths(template)
        missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
        if missing or extra:
            raise ValueError(f"checkpoint {path} does not fit: missing {missing}, unexpected {extra}")
        for k, t in want.items():
            shape = t.whole_shape if isinstance(t, Sharded) else tuple(t.shape)  # a split leaf: the whole one's
            if tuple(flat[k].shape) != tuple(shape):
                raise ValueError(f"{k}: checkpoint shape {tuple(flat[k].shape)} != {tuple(shape)}")
    return unflatten_paths(flat)


def state_fields(state) -> dict:
    """A training state dataclass (TrainState, FusedTrainState) minus its
    params: what a save holds besides the parameters."""
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state) if f.name != "params"}


def _load_into(live, saved, where: str):
    """Copy a saved tree into the live one of the same structure, tensor by
    tensor in place (shape and dtype must match); numbers are taken as saved."""
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(live) != set(saved):
            have = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
            raise ValueError(f"{where}: saved keys {have} do not match the live state's {sorted(live)}")
        for k in live:
            live[k] = _load_into(live[k], saved[k], f"{where}/{k}")
        return live
    if isinstance(live, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != live.shape or saved.dtype != live.dtype:
            got = (tuple(saved.shape), saved.dtype) if isinstance(saved, torch.Tensor) else type(saved).__name__
            raise ValueError(f"{where}: saved {got} does not fit the live {(tuple(live.shape), live.dtype)}")
        return live.copy_(saved)
    if type(saved) is not type(live):
        raise ValueError(f"{where}: saved {type(saved).__name__}, live {type(live).__name__}")
    return saved


def _restore_leaf(live, saved: torch.Tensor):
    """Copy a saved whole leaf into the live one, cast to its dtype: a split
    leaf takes only this rank's slice."""
    if isinstance(live, Sharded):
        live.local.copy_(take_slice(saved, live))
        return live
    return live.copy_(saved)


def restore_train_state(ckpt_path: str | Path, template, resume_run: bool = True, params_template=None,
                        params_transform=None, localize=None):
    """-> (state, aux). `template` is the live training state (TrainState or
    FusedTrainState); restored values are copied into its tensors. With
    resume_run=False only the params load (the optimizer, counters and seed
    stay the template's, aux is {}); otherwise the saved state fields load
    too, or, for a params-only checkpoint, the template's stay with a
    warning. With params_template (a tree of tensors or meta tensors giving
    paths, shapes and dtypes) the params restore into that structure on the
    template's device (on the host where the live params hold `Sharded`
    slices) and `params_transform` maps them into the live one.
    `localize` maps the saved state fields (one-rank layout) to the live
    state's (a rank's slices of its split moments and accumulators, or its
    rows of the fused step's row-split moments)."""
    path = Path(ckpt_path)
    if not (path / PARAMS_FILE).exists():
        path = _resolve_latest_step(path)
    live = flatten_paths(template.params)
    device = held(next(iter(live.values()))).device
    if params_template is None:
        saved = flatten_paths(restore_params(path, template.params))
        params = unflatten_paths({k: _restore_leaf(v, saved[k]) for k, v in live.items()})
    else:  # where the live leaves are split, the transform places the host tree's shares
        dest = "cpu" if any(isinstance(v, Sharded) for v in live.values()) else device
        saved = flatten_paths(restore_params(path, params_template))
        params = unflatten_paths({k: saved[k].to(device=dest, dtype=t.dtype)
                                  for k, t in flatten_paths(params_template).items()})
        if params_transform is not None:
            params = params_transform(params)
    if not resume_run:
        return dataclasses.replace(template, params=params), {}
    aux_file = path / AUX_FILE
    aux = json.loads(aux_file.read_text()) if aux_file.exists() else {}
    if not (path / STATE_FILE).exists():
        logging.getLogger("intact_tpu_torch.checkpoint").warning(
            "resume_run=True but %s holds no training state (params only); continuing with a fresh "
            "optimizer and counters", path)
        return dataclasses.replace(template, params=params), aux
    fields = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
    if localize is not None:
        fields = localize(fields)
    restored = _load_into(state_fields(template), fields, STATE_FILE)
    return dataclasses.replace(template, params=params, **restored), aux
