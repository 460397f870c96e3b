"""The rank processes of tests/test_torch_distributed.py, spawned with
torch.multiprocessing into a gloo group on the CPU. This module holds no test
and imports no JAX: a rank runs only the port.

Each entry takes (rank, world, port, workdir): it joins the group through
`parallel.distributed.initialize("cpu")` from torchrun's variables, reads
its inputs from workdir/inputs.pt (written by the test) and writes what it
measured to workdir/<task>_rank<r>.pt for the test to compare.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
JOINT_RECIPE = REPO / "config/train/pi0_finetune_bridge.yaml"


def _join(rank: int, world: int, port: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from intact_tpu_torch.parallel import distributed

    distributed.initialize("cpu")


def tiny_pipeline(min_quant_elems: int = 1024) -> None:
    """The trainer's model JSON read as Pi0Config.tiny() (its
    train_expert_only kept), 8-bit moments from `min_quant_elems` elements."""
    from intact_tpu_torch.config import pipeline
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.train import optim8bit

    optim8bit.MIN_QUANT_ELEMS = min_quant_elems
    pipeline.pi0_config_from_json = lambda d: dataclasses.replace(
        Pi0Config.tiny(), train_expert_only=bool(d.get("train_expert_only", False)))


def recipe_config(recipe: Path, **overrides):
    from intact_tpu_torch import run

    argv = ["--config_path", str(recipe)]
    for k, v in {"tokenizer_path": "hash", "log_freq": 1, **overrides}.items():
        argv += [f"--{k}", str(v)]
    return run.build_config(argv)[0]


def frame_keys(batch: dict) -> list[str]:
    """One fingerprint per frame of a raw batch (its actions and proprio)."""
    act, prop = batch["action"], batch["observation"]["proprio"]
    return [hashlib.sha1(act[i].tobytes() + prop[i].tobytes()).hexdigest() for i in range(act.shape[0])]


def _flat_clone(tree) -> dict:
    from intact_tpu_torch.models.common import flatten_paths

    return {k: v.detach().clone() for k, v in flatten_paths(tree).items()}


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

def standard_steps(inputs: dict, data: int, fsdp: int, one_rank: bool = False) -> dict:
    """The standard step (8-bit AdamW, clip, accumulation 2, SR off) on a
    data x fsdp mesh, each rank on its rows of the global micro-batches; with
    `one_rank` on one rank without a group, on the whole micro-batches."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.parallel import MeshConfig, local_rows, make_mesh
    from intact_tpu_torch.parallel.mesh import single_rank_mesh
    from intact_tpu_torch.train.optim import OptimizerConfig, make_optimizer
    from intact_tpu_torch.train.train_step import init_train_state, make_train_step

    from intact_tpu_torch.parallel import collectives

    cfg, policy = Pi0Config.tiny(), cm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
    mesh = single_rank_mesh() if one_rank else make_mesh(MeshConfig(data=data, fsdp=fsdp))
    collectives.reset()
    tx, _ = make_optimizer(OptimizerConfig(**inputs["std_opt"]), None, mesh=mesh)
    state = init_train_state(cm.unflatten_paths(_flat_clone(inputs["params"])), tx, seed=0)
    step = make_train_step(lambda p, rng, b, n, t: pi0.compute_loss(p, rng, b, cfg, policy, noise=n, time=t), tx)
    losses = []
    for batch, noise, time in zip(inputs["std_batches"], inputs["std_noise"], inputs["std_time"]):
        rows = local_rows({**batch, "noise": noise, "time": time}, mesh.rank, mesh.size)
        state, metrics = step(state, rows, noise=rows.pop("noise"), time=rows.pop("time"))
        losses.append(metrics["l2_loss"].item())
    counts = collectives.counts()  # the update's, before the moments are gathered
    moments = tx.global_state(state.opt_state, state.params)
    q_rows = {k: m["q"].shape[0] for k, m in state.opt_state["mu"].items() if isinstance(m, dict)}
    return {"losses": losses, "params": _flat_clone(state.params), "mu": cm.flatten_paths(moments["mu"]),
            "local_q_rows": q_rows, "collectives": counts}


def fused_steps(inputs: dict, data: int, fsdp: int, same_rows: bool, bf16: bool) -> dict:
    """One fused step on a data x fsdp mesh (block 8, 8-bit moments from 64
    elements); with `same_rows` every rank takes the whole batch, so the
    reduced gradient is one rank's bit for bit. Also the same step on one
    rank without a group (this process, the same threads) for comparison."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.parallel import MeshConfig, local_rows, make_mesh
    from intact_tpu_torch.parallel.mesh import single_rank_mesh
    from intact_tpu_torch.train import fused_joint as fj
    from intact_tpu_torch.train.optim import OptimizerConfig

    cfg = Pi0Config.tiny()
    dtype = torch.bfloat16 if bf16 else torch.float32
    policy = cm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    out = {}
    for name, mesh in (("ranks", make_mesh(MeshConfig(data=data, fsdp=fsdp))), ("one", single_rank_mesh())):
        params = cm.unflatten_paths({k: v.to(dtype) for k, v in _flat_clone(inputs["params"]).items()})
        state = fj.init_fused_state(params, seed=7, block_size=8, min_quant_elems=64, mesh=mesh)
        step = fj.make_fused_joint_step(cfg, OptimizerConfig(**inputs["fused_opt"]), policy, block_size=8,
                                        stochastic_rounding=bf16, scale_mode="exact", mesh=mesh)
        rows = {**inputs["fused_batch"], "noise": inputs["fused_noise"], "time": inputs["fused_time"]}
        if name == "ranks" and not same_rows:
            rows = local_rows(rows, mesh.rank, mesh.size)
        noise, time = rows.pop("noise"), rows.pop("time")
        counts = []
        for _ in range(2):
            state, metrics = step(state, rows, noise=noise, time=time, salt=inputs["fused_salt"])
            counts.append((metrics["l2_loss"].item(), metrics["grad_norm"].item()))
        mu, nu = fj.global_moments(state, mesh, block_size=8)
        out[name] = {"metrics": counts, "params": _flat_clone(state.params), "mu": _flat_clone(mu),
                     "nu": _flat_clone(nu), "local_rows": state.mu["vlm"]["blocks"]["q"].shape[1]}
    return out


def checkpoint_round_trip(inputs: dict, workdir: Path) -> dict:
    """Resume the test's one-rank checkpoint on two fsdp ranks, then take one
    update on the ranks' rows of a global batch and save it from the ranks."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.parallel import local_rows
    from intact_tpu_torch.train import checkpoint as ckpt
    from intact_tpu_torch.train.trainer import Trainer

    tiny_pipeline()
    saved_dir = Path(inputs["ckpt_step"])
    trainer = Trainer(recipe_config(JOINT_RECIPE, **inputs["ckpt_overrides"], **{
        "mesh.fsdp": 2, "per_device_batch_size": 2, "log_dir": workdir / "two", "load_from_checkpoint": saved_dir}),
        device="cpu")
    saved_fields = torch.load(saved_dir / ckpt.STATE_FILE, weights_only=True)
    saved_params = torch.load(saved_dir / ckpt.PARAMS_FILE, weights_only=True)
    gathered = cm.flatten_paths(trainer._global_fields()["opt_state"])
    want = cm.flatten_paths(saved_fields["opt_state"])
    restored_equal = (set(gathered) == set(want) and all(
        torch.equal(v, want[k]) if isinstance(v, torch.Tensor) else v == want[k] for k, v in gathered.items())
        and all(torch.equal(v, saved_params[k]) for k, v in cm.flatten_paths(trainer.state.params).items()))
    rows = local_rows({**inputs["ckpt_batch"], "noise": inputs["ckpt_noise"], "time": inputs["ckpt_time"]},
                      trainer.mesh.rank, trainer.mesh.size)
    noise, time = rows.pop("noise"), rows.pop("time")
    trainer.state, metrics = trainer.train_step(trainer.state, rows, noise=noise, time=time)
    trainer.cnt_update += 1
    path = trainer.save()
    # the trainer's episodes: this rank's shard of the synthetic stream
    frames, data = [], iter(trainer.train_data)
    while len(frames) < inputs["shard_frames"]:
        frames += frame_keys(next(data))
    local_q = {k: m["q"].shape[0] for k, m in trainer.state.opt_state["mu"].items() if isinstance(m, dict)}
    return {"restored_equal": restored_equal, "saved": str(path), "params": _flat_clone(trainer.state.params),
            "loss": metrics["l2_loss"].item(), "frames": frames[:inputs["shard_frames"]], "local_q_rows": local_q}


def pair(rank: int, world: int, port: int, workdir: str) -> None:
    """Every two-rank check in one group."""
    import numpy as np

    from intact_tpu_torch.parallel import distributed

    _join(rank, world, port)
    workdir = Path(workdir)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    result = {"backend": distributed.backend(), "world": distributed.process_count(),
              "index": distributed.process_index()}
    result["mean"] = distributed.process_mean({"loss": 1.0 + 2.0 * rank, "acc": float(rank)})
    result["broadcast"] = distributed.broadcast_from_host0(np.full(3, 10.0 + rank, np.float32)).tolist()
    tiny_pipeline()
    for data, fsdp in ((2, 1), (1, 2)):
        result[f"std_{data}x{fsdp}"] = standard_steps(inputs, data, fsdp)
    # no leaf large enough to split: the fsdp ranks count only the replicated leaves, on rank 0
    from intact_tpu_torch.train import optim8bit

    optim8bit.MIN_QUANT_ELEMS = 10**9
    result["std_unsplit"] = {"ranks": standard_steps(inputs, 1, 2), "one": standard_steps(inputs, 1, 1, one_rank=True)}
    tiny_pipeline()
    for name, (data, fsdp, same, bf16) in {"fused_same_2x1": (2, 1, True, True), "fused_same_1x2": (1, 2, True, True),
                                           "fused_rows_2x1": (2, 1, False, False)}.items():
        result[name] = fused_steps(inputs, data, fsdp, same, bf16)
    result["ckpt"] = checkpoint_round_trip(inputs, workdir)
    torch.save(result, workdir / f"pair_rank{rank}.pt")
    distributed.destroy()


# ---------------------------------------------------------------------------
# four ranks: a repo recipe, its mesh unchanged
# ---------------------------------------------------------------------------

def quad(rank: int, world: int, port: int, workdir: str) -> None:
    """config/train/pi0_finetune_bridge.yaml with its mesh (data -1, fsdp 4)
    at world 4: one update with validation and the last update's save."""
    from intact_tpu_torch.parallel import collectives, distributed
    from intact_tpu_torch.train.trainer import Trainer

    _join(rank, world, port)
    workdir = Path(workdir)
    tiny_pipeline()
    cfg = recipe_config(JOINT_RECIPE, per_device_batch_size=2, global_batch_size=8, n_updates=1, eval_freq=1,
                        eval_size=8, log_dir=workdir / "quad")
    trainer = Trainer(cfg, device="cpu")
    losses, validations = [], []
    real_step, real_validate = trainer.train_step, trainer.validate

    def step(state, batch):
        state, metrics = real_step(state, batch)
        losses.append(metrics["l2_loss"].item())
        return state, metrics

    trainer.train_step = step
    trainer.validate = lambda: validations.append(real_validate()) or validations[-1]
    collectives.reset()
    trainer.train()
    local_q = {k: m["q"].shape[0] for k, m in trainer.state.opt_state["mu"].items() if isinstance(m, dict)}
    torch.save({"mesh": trainer.mesh.shape, "accum": trainer.opt_cfg.grad_accumulation_steps, "losses": losses,
                "validations": validations, "params": _flat_clone(trainer.state.params), "local_q_rows": local_q,
                "collectives": collectives.counts(), "ckpt_root": str(trainer.ckpt_root), "name": cfg.name},
               workdir / f"quad_rank{rank}.pt")
    distributed.destroy()
