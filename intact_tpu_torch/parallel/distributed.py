"""The process group and host-side collectives (intact_tpu/parallel/distributed.py).

`initialize(device)` joins the process group that the launcher describes, once
per process:
  * torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT;
  * or the JAX package's COORDINATOR_ADDRESS ("host:port"), NUM_PROCESSES and
    PROCESS_ID, mapped onto them (LOCAL_RANK defaults to the rank).
Without either it is a world of one with no group. The backend follows the
device the caller asked for: NCCL on CUDA, after torch.cuda.set_device(
LOCAL_RANK), and gloo for device "cpu". A failed NCCL init raises; nothing
falls back to gloo. It returns this rank's device: cuda:LOCAL_RANK, or the
CPU. Like every entry point it runs on CUDA unless given "cpu", and raises
without a CUDA device.

`process_mean` and `broadcast_from_host0` are the host-side helpers the
trainer uses (validation metrics, logged metrics); they are no-ops in a world
of one without a group.
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from intact_tpu_torch.parallel import collectives

log = logging.getLogger("intact_tpu_torch.distributed")
TIMEOUT = datetime.timedelta(minutes=10)
_state: dict = {"device": None}


def _launch_env() -> dict | None:
    """RANK/WORLD_SIZE/LOCAL_RANK/MASTER_ADDR/MASTER_PORT from torchrun's or
    the JAX package's variables; None when neither describes a group."""
    env = os.environ
    if "WORLD_SIZE" in env and "RANK" in env:
        return {"rank": int(env["RANK"]), "world": int(env["WORLD_SIZE"]),
                "local_rank": int(env.get("LOCAL_RANK", env["RANK"])),
                "addr": env.get("MASTER_ADDR", "localhost"), "port": int(env.get("MASTER_PORT", "29500"))}
    coord = env.get("COORDINATOR_ADDRESS")
    if coord:
        addr, _, port = coord.rpartition(":")
        rank = int(env["PROCESS_ID"])
        return {"rank": rank, "world": int(env["NUM_PROCESSES"]), "local_rank": int(env.get("LOCAL_RANK", rank)),
                "addr": addr or "localhost", "port": int(port)}
    return None


def initialize(device: str | torch.device | None = None) -> torch.device:
    """Join the launcher's process group, once per process -> this rank's
    device. Without a launcher (and without a group) it only resolves the
    device, so a later call can still join one."""
    from intact_tpu_torch.models.common import resolve_device

    device = resolve_device(device)
    if dist.is_initialized():
        joined = _state["device"]
        if joined is not None and joined.type != device.type:
            raise ValueError(f"the process group was initialized for {joined}, not {device}")
        return joined or device
    launch = _launch_env()
    if launch is None:
        return device
    if device.type == "cuda":
        torch.cuda.set_device(launch["local_rank"])
        device = torch.device("cuda", launch["local_rank"])
        backend, kw = "nccl", {"device_id": device}
    else:
        backend, kw = "gloo", {}
    dist.init_process_group(backend, init_method=f"tcp://{launch['addr']}:{launch['port']}",
                            rank=launch["rank"], world_size=launch["world"], timeout=TIMEOUT, **kw)
    _state["device"] = device
    log.info("process group (%s): rank %d of %d on %s", backend, launch["rank"], launch["world"], device)
    return device


def destroy() -> None:
    """Leave the process group (if any) and its meshes' groups; initialize
    may run again after."""
    from intact_tpu_torch.parallel import mesh

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    mesh._GROUPS.clear()
    _state["device"] = None


def backend() -> str | None:
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _group_device() -> torch.device:
    if backend() == "nccl":
        return _state["device"] or torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_mean(values: dict[str, float]) -> dict[str, float]:
    """Mean of host-side python metrics over the ranks (one all-reduce of the
    values, sorted by key, in float64; a no-op without a group). The keys
    keep their order."""
    if not (dist.is_available() and dist.is_initialized()):
        return dict(values)
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64, device=_group_device())
    collectives.all_reduce(t, dist.group.WORLD)
    mean = dict(zip(keys, (t / dist.get_world_size()).tolist()))
    return {k: float(mean[k]) for k in values}


def broadcast_from_host0(value: np.ndarray) -> np.ndarray:
    """Rank 0's array on every rank (every rank passes one of the same shape and dtype)."""
    if not (dist.is_available() and dist.is_initialized()):
        return value
    t = torch.from_numpy(np.ascontiguousarray(value)).to(_group_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def barrier() -> None:
    if dist.is_available() and dist.is_initialized():
        if backend() == "nccl":
            dist.barrier(device_ids=[_group_device().index])
        else:
            dist.barrier()
