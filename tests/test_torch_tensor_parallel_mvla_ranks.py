"""The rank processes of tests/test_torch_tensor_parallel_mvla.py, spawned with
torch.multiprocessing into a gloo group on the CPU. This module holds no test
and imports no JAX: a rank runs only the port.

Each entry takes (rank, world, port, workdir): it joins the group through
`parallel.distributed.initialize("cpu")` (one thread, as the references the
test holds it to), reads its inputs from workdir/inputs.pt and writes what
it measured to workdir/<entry>_rank<r>.pt. Meshes are (data, fsdp, tensor);
tensor is the fastest axis.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

import test_torch_distributed_ranks as dist_child
import test_torch_serve_ranks_child as serve_child

CASES = ("mvla", "mmmvla", "dit")
INPUTS = ("images", "img_masks", "lang_tokens", "lang_masks", "state")
CONNECTOR_HEADS = 4  # the tiny connector's 2 heads do not split over 4 ranks
DIT = dict(action_head="dit", dit_width=32, dit_depth=2, dit_heads=2, diffusion_steps=20)


def config(case: str, expert_only: bool = False):
    """MVLAConfig.tiny() with a 4-head connector: the self/cross expert
    ("mvla"), the joint one ("mmmvla") or the DiT head ("dit")."""
    from intact_tpu_torch.models.mvla.config import MVLAConfig

    cfg = MVLAConfig.tiny()
    cfg = dataclasses.replace(cfg, connector=dataclasses.replace(cfg.connector, num_heads=CONNECTOR_HEADS),
                              train_expert_only=expert_only)
    if case == "mmmvla":
        return dataclasses.replace(cfg, alternate_pattern="joint")
    return dataclasses.replace(cfg, **DIT) if case == "dit" else cfg


def tensor_split(params) -> list[str]:
    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.parallel.sharding import Sharded

    return sorted(k for k, v in flatten_paths(params).items() if isinstance(v, Sharded) and v.tensor is not None)


def sample(spec: dict, mesh=None, quantize: bool = False) -> dict:
    """A case's prompt and actions (sample_actions on the given noise) on
    `mesh` (its batch coordinate's rows) or on one rank without one, in fp32
    compute, int8 with `quantize`."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.mvla import model
    from intact_tpu_torch.parallel import local_rows
    from intact_tpu_torch.parallel.sharding import shard_tree

    cfg = config(spec["case"])
    params = cm.unflatten_paths(dist_child._flat_clone(spec["params"]))
    if quantize:
        params = cm.quantize_params(params, consume=True)
    inputs = spec["inputs"]
    if mesh is not None:
        params = shard_tree(params, mesh, consume=True, heads=model.tensor_heads(cfg))
        inputs = local_rows(inputs, mesh.batch_index, mesh.batch_size)
    args = [inputs[k] for k in INPUTS]
    with torch.inference_mode():
        prompt = model.compute_prompt(params, *args[:4], cfg, cm.FP32_POLICY)
    actions = model.sample_actions(params, None, *args, cfg, cm.FP32_POLICY, noise=inputs["noise"])
    return {"prompt": prompt, "actions": actions, "split": tensor_split(params)}


def cases(inputs: dict, mesh_shape: tuple) -> dict:
    """Every case in fp32 and int8 on the mesh -> {case: {"fp32", "int8":
    sample's result with the collectives it ran, the rank's coordinates}}."""
    from intact_tpu_torch.parallel import MeshConfig, collectives, make_mesh

    mesh = make_mesh(MeshConfig(*mesh_shape))
    out = {}
    for case in CASES:
        res = {"batch_index": mesh.batch_index, "tensor_index": mesh.tensor_index}
        for precision in ("fp32", "int8"):
            collectives.reset()
            res[precision] = sample(inputs["cases"][case], mesh, quantize=precision == "int8")
            res[precision]["collectives"] = collectives.counts()
        out[case] = res
    return out


def standard_steps(inputs: dict, recipe: str, mesh_shape: tuple) -> dict:
    """MVLA's standard step ("full": everything trains, 8-bit AdamW;
    "expert": train_expert_only, the frozen tower's mask, AdamW) for two
    micro-steps on the mesh, each batch coordinate on its rows of the global
    micro-batches with the JAX step's draws."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.mvla import model
    from intact_tpu_torch.parallel import MeshConfig, collectives, local_rows, make_mesh
    from intact_tpu_torch.parallel.sharding import Sharded, shard_tree
    from intact_tpu_torch.train import optim8bit
    from intact_tpu_torch.train.optim import OptimizerConfig, make_optimizer
    from intact_tpu_torch.train.train_step import init_train_state, make_train_step

    optim8bit.MIN_QUANT_ELEMS = inputs["min_quant"]
    spec = inputs["std"][recipe]
    cfg = config("mvla", expert_only=recipe == "expert")
    mesh = make_mesh(MeshConfig(*mesh_shape))
    params = shard_tree(cm.unflatten_paths(dist_child._flat_clone(spec["params"])), mesh, consume=True,
                        heads=model.tensor_heads(cfg))
    mask = cm.unflatten_paths(spec["mask"]) if spec["mask"] is not None else None
    tx, _ = make_optimizer(OptimizerConfig(**spec["opt"]), mask, mesh=mesh)
    state = init_train_state(params, tx, seed=0)
    step = make_train_step(lambda p, rng, b, n, t: model.compute_loss(p, rng, b, cfg, cm.FP32_POLICY, noise=n,
                                                                      time=t), tx)
    collectives.reset()
    losses, norms = [], []
    for i, batch in enumerate(spec["batches"]):
        rows = local_rows({**batch, "noise": spec["noise"][i], "time": spec["time"][i]}, mesh.batch_index,
                          mesh.batch_size)
        state, metrics = step(state, rows, noise=rows.pop("noise"), time=rows.pop("time"))
        losses.append(metrics["l2_loss"].item())
        norms.append([metrics["grad_norm"].item(), metrics["param_norm"].item()])
    counts = collectives.counts()
    fsdp_split = sorted(k for k, v in cm.flatten_paths(state.params).items() if isinstance(v, Sharded) and v.fsdp_split)
    return {"losses": losses, "norms": norms, "params": dist_child.whole_tree(state.params),
            "split": tensor_split(state.params), "fsdp_split": fsdp_split, "partial": sorted(tx.partial),
            "collectives": counts, "batch_index": mesh.batch_index}


def wrapper_actions(inputs: dict, mesh_shape: tuple) -> dict:
    """The server role's int8 mvla_tiny wrapper (random weights from its
    seed) over the mesh: rank 0 samples the batch over the serving group on
    the given noise, the other ranks follow -> rank 0's actions, and every
    rank's tensor-split paths."""
    from intact_tpu_torch.parallel import MeshConfig, make_mesh

    wrapper = serve_child.pi0_wrapper(inputs, make_mesh(MeshConfig(*mesh_shape)), quantize=True,
                                      model_type="mvla_tiny")
    serve_child.fixed_noise(wrapper, inputs["wrapper_noise"])
    actions = serve_child.run_wrapper(wrapper, [inputs["wrapper_batch"]])
    return {"actions": actions, "split": tensor_split(wrapper.policy.params)}


def _run(name: str, rank: int, world: int, port: int, workdir: str, tasks) -> None:
    from intact_tpu_torch.parallel import distributed

    dist_child._join(rank, world, port)
    workdir = Path(workdir)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    result = {key: fn(inputs) for key, fn in tasks}
    torch.save(result, workdir / f"{name}_rank{rank}.pt")
    distributed.destroy()


def pair(rank: int, world: int, port: int, workdir: str) -> None:
    """Two ranks, (1, 1, 2): every case, both standard-step recipes, and
    the server role's int8 wrapper."""
    mesh = (1, 1, 2)
    _run("pair", rank, world, port, workdir, [
        ("cases", lambda i: cases(i, mesh)),
        ("full", lambda i: standard_steps(i, "full", mesh)),
        ("expert", lambda i: standard_steps(i, "expert", mesh)),
        ("wrapper", lambda i: wrapper_actions(i, mesh)),
    ])


def quad(rank: int, world: int, port: int, workdir: str) -> None:
    """Four ranks: every case at (1, 1, 4) (only the connector's 4 heads,
    SigLIP's 4 and the MLPs split) and at (1, 2, 2) (each tensor slice split
    further over fsdp, two batch coordinates), both recipes at (1, 2, 2)."""
    _run("quad", rank, world, port, workdir, [
        ("1x1x4", lambda i: cases(i, (1, 1, 4))),
        ("1x2x2", lambda i: cases(i, (1, 2, 2))),
        ("full_1x2x2", lambda i: standard_steps(i, "full", (1, 2, 2))),
        ("expert_1x2x2", lambda i: standard_steps(i, "expert", (1, 2, 2))),
    ])
