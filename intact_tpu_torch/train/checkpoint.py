"""Parameter checkpoints in a torch format, with the reference's directory contract.

<ckpt_root>/step_{n}/ per save (n = the gradient-update count), holding
`params.pt` (the parameter tree flattened to {"a/b/c": tensor} on the host,
written with torch.save) and `auxiliary_data.json`, written last: its
presence is the commit marker, so a crash mid-save leaves a step dir that
restore skips. A root dir resolves to its newest committed step; a step dir
is restored as given. As intact_tpu/train/checkpoint.py, params only: the
optimizer state and resuming a run are not ported yet.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path

import torch

from intact_tpu_torch.models.common import flatten_paths, unflatten_paths

PARAMS_FILE = "params.pt"
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


def save_checkpoint(ckpt_root: str | Path, params, step: int, aux: dict | None = None) -> Path:
    """Write step_{step}/params.pt, then auxiliary_data.json as the commit
    marker. A committed step is never overwritten (raises); the leftovers of
    a crash mid-save at this step are cleared first."""
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
    auxiliary = {"cnt_update": int(step)}
    auxiliary.update(aux or {})
    (path / AUX_FILE).write_text(json.dumps(auxiliary, indent=2))
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
            if tuple(flat[k].shape) != tuple(t.shape):
                raise ValueError(f"{k}: checkpoint shape {tuple(flat[k].shape)} != {tuple(t.shape)}")
    return unflatten_paths(flat)
