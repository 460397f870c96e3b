"""The rank processes of tests/test_torch_tensor_parallel.py, spawned with
torch.multiprocessing into a gloo group on the CPU. This module holds no test
and imports no JAX: a rank runs only the port.

Each entry takes (rank, world, port, workdir): it joins the group through
`parallel.distributed.initialize("cpu")` from torchrun's variables, reads its
inputs from workdir/inputs.pt (written by the test) and writes what it
measured to workdir/<entry>_rank<r>.pt for the test to compare. Meshes are
(data, fsdp, tensor); tensor is the fastest axis.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

import test_torch_distributed_ranks as dist_child

JOINT_RECIPE = dist_child.JOINT_RECIPE


def config(name: str, expert: bool = False):
    """Pi0Config.tiny() ("tiny"), or its variant with 4 query heads over the
    one K/V head in both Gemma streams ("tiny4", for tensor 4)."""
    from intact_tpu_torch.models.pi0.config import Pi0Config

    cfg = Pi0Config.tiny()
    if name == "tiny4":
        cfg = dataclasses.replace(cfg, vlm=dataclasses.replace(cfg.vlm, num_heads=4),
                                  expert=dataclasses.replace(cfg.expert, num_heads=4))
    return dataclasses.replace(cfg, train_expert_only=expert)


def tensor_split(params) -> list[str]:
    """The paths of the leaves this rank holds a tensor slice of."""
    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.parallel.sharding import Sharded

    return sorted(k for k, v in flatten_paths(params).items() if isinstance(v, Sharded) and v.tensor is not None)


def standard_steps(inputs: dict, task: str, mesh_shape: tuple) -> dict:
    """A standard-step task (a config's params, freeze mask, optimizer, two
    micro-batches, the JAX step's draws) on a (data, fsdp, tensor) mesh, each
    batch coordinate on its rows of the global micro-batches."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0 import model
    from intact_tpu_torch.parallel import MeshConfig, collectives, local_rows, make_mesh
    from intact_tpu_torch.parallel.sharding import Sharded, shard_tree
    from intact_tpu_torch.train.optim import OptimizerConfig, make_optimizer
    from intact_tpu_torch.train.train_step import init_train_state, make_train_step

    spec = inputs["std"][task]
    cfg = config(spec["config"], spec["expert"])
    policy = cm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
    mesh = make_mesh(MeshConfig(*mesh_shape))
    params = shard_tree(cm.unflatten_paths(dist_child._flat_clone(spec["params"])), mesh, consume=True,
                        heads=model.tensor_heads(cfg))
    mask = cm.unflatten_paths(spec["mask"]) if spec["mask"] is not None else None
    tx, _ = make_optimizer(OptimizerConfig(**spec["opt"]), mask, mesh=mesh)
    state = init_train_state(params, tx, seed=0)
    step = make_train_step(lambda p, rng, b, n, t: model.compute_loss(p, rng, b, cfg, policy, noise=n, time=t), tx)
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


def policy_actions(inputs: dict, name: str, mesh_shape: tuple, quantize: bool) -> dict:
    """Pi0Policy(mesh=) on the JAX policy's weights and first noise draw: at
    one batch coordinate every rank samples the whole batch; at several, the
    serving group (serve/group.py) splits the padded batch over the
    coordinates and gathers each one's actions from its tensor rank 0, rank 0
    sending the calls. -> this rank's own output and the gathered actions."""
    import numpy as np

    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0.policy import Pi0Policy
    from intact_tpu_torch.parallel import MeshConfig, collectives, make_mesh
    from intact_tpu_torch.parallel.sharding import pad_rows
    from intact_tpu_torch.serve.group import ServeGroup

    spec = inputs["policy"][name]
    mesh = make_mesh(MeshConfig(*mesh_shape))
    policy = Pi0Policy(config(name), params=cm.unflatten_paths(dist_child._flat_clone(spec["params"])),
                       use_bf16=False, tokenizer_path="hash", device="cpu", quantize=quantize, mesh=mesh)
    own = []
    real = policy._sample_rows

    def rows(*arrays, noise=None):
        out = real(*arrays, noise=noise)
        own.append(out.clone())
        return out

    collectives.reset()
    arrays = [policy._put(x) for x in policy.prepare_inputs(spec["batch"])]
    if mesh.batch_size == 1:
        gathered = rows(*arrays, noise=spec["noise"])
    else:
        group = ServeGroup(mesh, "cpu")
        group.on("sample", lambda *a: rows(*a[:-1], noise=a[-1]))
        if mesh.rank == 0:
            n = arrays[0].shape[0]
            padded = pad_rows([np.asarray(a) for a in arrays] + [spec["noise"].numpy()], mesh.batch_size)
            gathered = group.call("sample", padded)[:n]
            group.stop()
        else:
            group.follow()
            gathered = None
    return {"own": own[0], "gathered": gathered, "split": tensor_split(policy.params),
            "collectives": collectives.counts(), "batch_index": mesh.batch_index}


def moments_check(inputs: dict, mesh_shape: tuple) -> dict:
    """adam8bit_slice on this rank's part of each case's leaf (a tensor slice,
    split further over fsdp where the mesh has it), two steps of the same
    whole gradients, the block scales' max one MAX all-reduce over the model
    group: the gathered codes, the scales and the directions against one
    rank's adam8bit_leaf on the whole leaf, bit for bit."""
    from intact_tpu_torch.parallel import MeshConfig, collectives, make_mesh
    from intact_tpu_torch.parallel.sharding import gather_leaf, shard_leaf, take_slice
    from intact_tpu_torch.train import optim8bit

    mesh = make_mesh(MeshConfig(*mesh_shape))
    hyper = dict(c1=0.1, c2=0.001, b1=0.9, b2=0.999, eps=1e-8)
    out = {}
    for case, (path, whole, grads) in inputs["moments"].items():
        like = shard_leaf(path, whole, mesh)
        layout = optim8bit.slice_layout(like.shape, like.dim, like.parts, like.index, like.tensor)
        mine = [optim8bit.init_slice_moment(like.local, like.whole_numel(), signed) for signed in (True, False)]
        one = [optim8bit.init_moment(whole, signed) for signed in (True, False)]
        equal = True
        for g in grads:
            local = take_slice(g, like).contiguous()
            got = torch.cat([u for _, u in optim8bit.adam8bit_slice(
                local, *mine, layout, lambda x: collectives.all_reduce_max(x, mesh.groups["model"]), **hyper)])
            want = torch.cat([u for _, u in optim8bit.adam8bit_leaf(g, *one, **hyper)]).view(whole.shape)
            got_whole = gather_leaf(got.view(like.local.shape), like)
            equal &= torch.equal(got_whole, want)
            for m, w, signed in zip(mine, one, (True, False)):
                codes = optim8bit.slice_to_rows(gather_leaf(m["q"], like), signed)
                equal &= torch.equal(codes, w["q"]) and torch.equal(m["scale"], w["scale"])
        out[case] = {"equal": bool(equal), "tensor": like.tensor is not None, "fsdp": like.fsdp_split,
                     "contiguous": layout.contiguous}
    return out


def checkpoint_run(inputs: dict, workdir: Path, mesh_shape: tuple) -> dict:
    """The joint recipe's Trainer on the mesh (8-bit moments with the tiny
    leaves quantized): one update on the first global batch, saved from the
    ranks, then one more on the second (each coordinate on its rows, the
    draws given) -> the uninterrupted run's params and the saved step."""
    from intact_tpu_torch.parallel import local_rows
    from intact_tpu_torch.train.trainer import Trainer

    dist_child.tiny_pipeline()
    data, fsdp, tensor = mesh_shape
    trainer = Trainer(dist_child.recipe_config(JOINT_RECIPE, **inputs["ckpt_overrides"], **{
        "mesh.data": data, "mesh.fsdp": fsdp, "mesh.tensor": tensor, "per_device_batch_size": 2,
        "log_dir": workdir / "tp_ckpt"}), device="cpu")
    saved = None
    for i, batch in enumerate(inputs["ckpt_batches"]):
        rows = local_rows({**batch, "noise": inputs["ckpt_noise"][i], "time": inputs["ckpt_time"][i]},
                          trainer.mesh.batch_index, trainer.mesh.batch_size)
        trainer.state, _ = trainer.train_step(trainer.state, rows, noise=rows.pop("noise"), time=rows.pop("time"))
        trainer.cnt_update += 1
        if i == 0:
            saved = trainer.save()
    return {"saved": str(saved), "params": dist_child.whole_tree(trainer.state.params),
            "split": tensor_split(trainer.state.params), "mesh": trainer.mesh.shape}


def rounded_update(inputs: dict, workdir: Path, mesh_shape: tuple) -> dict:
    """The joint recipe's Trainer as the recipe has it (bf16 masters, 8-bit
    moments, stochastic rounding) for one update on the mesh -> the rank's
    gathered params: the tensor slices round with their own generators, the
    leaves replicated over tensor alike on every rank."""
    from intact_tpu_torch.train.trainer import Trainer

    dist_child.tiny_pipeline()
    data, fsdp, tensor = mesh_shape
    trainer = Trainer(dist_child.recipe_config(JOINT_RECIPE, **{
        "mesh.data": data, "mesh.fsdp": fsdp, "mesh.tensor": tensor, "per_device_batch_size": 2,
        "global_batch_size": 2 * data * fsdp, "n_updates": 1, "save_model_freq": 10, "log_dir": workdir / "tp_sr"}),
        device="cpu")
    before = dist_child.whole_tree(trainer.state.params)
    trainer.train()
    after = dist_child.whole_tree(trainer.state.params)
    return {"params": after, "moved": sorted(k for k, v in after.items() if not torch.equal(v, before[k])),
            "bf16": all(v.dtype == torch.bfloat16 for v in after.values() if v.is_floating_point())}


def staged_collectives(inputs: dict, workdir: Path) -> dict:
    """The staging rule on the CPU: with `collectives.staged` answering yes
    for every tensor (as it does for a CUDA tensor on a gloo group), each
    collective runs through `_on_host` and equals the unstaged one, counted
    once per call by `staged_calls()`."""
    import torch.distributed as dist

    from intact_tpu_torch.parallel import collectives

    group, rank = dist.group.WORLD, dist.get_rank()

    def run() -> list:
        x = torch.arange(6, dtype=torch.float32).view(2, 3) + rank
        out = torch.empty(4, 3)
        return [collectives.all_reduce(x.clone(), group), collectives.all_reduce_max(x.clone(), group),
                collectives.tensor_all_gather(out, x.clone(), group), collectives.broadcast(x.clone(), group),
                collectives.reduce_scatter(torch.empty(3), x.clone().view(-1), group)]

    collectives.reset()
    plain = run()
    real = collectives.staged
    collectives.staged = lambda x, g: True
    try:
        collectives.reset()
        staged = run()
        calls = collectives.staged_calls()
    finally:
        collectives.staged = real
    return {"equal": all(torch.equal(a, b) for a, b in zip(plain, staged)), "calls": calls,
            "counted": collectives.counts()["all_reduce"]}


def _run(name: str, rank: int, world: int, port: int, workdir: str, tasks) -> None:
    from intact_tpu_torch.parallel import distributed

    dist_child._join(rank, world, port)
    workdir = Path(workdir)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    dist_child.tiny_pipeline()
    result = {key: fn(inputs, workdir) for key, fn in tasks}
    torch.save(result, workdir / f"{name}_rank{rank}.pt")
    distributed.destroy()


def pair(rank: int, world: int, port: int, workdir: str) -> None:
    """Two ranks: (1, 1, 2)."""
    mesh = (1, 1, 2)
    _run("pair", rank, world, port, workdir, [
        ("std", lambda i, w: standard_steps(i, "joint", mesh)),
        ("expert", lambda i, w: standard_steps(i, "expert", mesh)),
        ("policy", lambda i, w: policy_actions(i, "tiny", mesh, quantize=False)),
        ("policy_int8", lambda i, w: policy_actions(i, "tiny", mesh, quantize=True)),
        ("moments", lambda i, w: moments_check(i, mesh)),
        ("staged", staged_collectives),
    ])


def quad(rank: int, world: int, port: int, workdir: str) -> None:
    """Four ranks: (1, 2, 2), (2, 1, 2) and (1, 1, 4) at the 4-head config."""
    _run("quad", rank, world, port, workdir, [
        ("std_1x2x2", lambda i, w: standard_steps(i, "joint", (1, 2, 2))),
        ("std_2x1x2", lambda i, w: standard_steps(i, "joint", (2, 1, 2))),
        ("expert_2x1x2", lambda i, w: standard_steps(i, "expert", (2, 1, 2))),
        ("std_1x1x4", lambda i, w: standard_steps(i, "joint4", (1, 1, 4))),
        ("expert_1x1x4", lambda i, w: standard_steps(i, "expert4", (1, 1, 4))),
        ("policy_1x1x4", lambda i, w: policy_actions(i, "tiny4", (1, 1, 4), quantize=False)),
        ("policy_int8_1x2x2", lambda i, w: policy_actions(i, "tiny", (1, 2, 2), quantize=True)),
        ("moments_1x2x2", lambda i, w: moments_check(i, (1, 2, 2))),
        ("ckpt", lambda i, w: checkpoint_run(i, w, (1, 2, 2))),
        ("rounded", lambda i, w: rounded_update(i, w, (1, 2, 2))),
    ])


def octo(rank: int, world: int, port: int, workdir: str) -> None:
    """Eight ranks: (2, 2, 2), as tests/test_parallel_train.py's mesh."""
    mesh = (2, 2, 2)
    _run("octo", rank, world, port, workdir, [
        ("std", lambda i, w: standard_steps(i, "joint", mesh)),
        ("expert", lambda i, w: standard_steps(i, "expert", mesh)),
        ("policy", lambda i, w: policy_actions(i, "tiny", mesh, quantize=False)),
    ])
