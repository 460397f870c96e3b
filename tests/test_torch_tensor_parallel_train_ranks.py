"""The rank processes of tests/test_torch_tensor_parallel_train.py, spawned with
torch.multiprocessing into a gloo group on the CPU. This module holds no test
and imports no JAX: a rank runs only the port.

Each entry takes (rank, world, port, workdir): it joins the group through
`parallel.distributed.initialize("cpu")` (one thread), reads its inputs from
workdir/inputs.pt and writes what it measured to workdir/<entry>_rank<r>.pt.
Meshes are (data, fsdp, tensor); tensor is the fastest axis.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

import test_torch_distributed_ranks as dist_child
import test_torch_tensor_parallel_ranks as tp_child

FUSED_RECIPE = dist_child.REPO / "config/train/pi0_finetune_bridge_1chip.yaml"
FAST_RECIPE = dist_child.FAST_RECIPE
FUSED_BLOCK = 8
FUSED_MIN_QUANT = 64


def fast_config(name: str, vocab: int):
    """Pi0FASTConfig.tiny() ("tiny"), or its variant with 4 query heads over
    the one K/V head ("tiny4", for tensor 4), at a vocabulary of `vocab` rows."""
    from intact_tpu_torch.models.pi0fast.config import Pi0FASTConfig

    cfg = Pi0FASTConfig.tiny()
    vlm = dataclasses.replace(cfg.vlm, vocab_size=vocab, num_heads=4 if name == "tiny4" else cfg.vlm.num_heads)
    return dataclasses.replace(cfg, vlm=vlm)


def fast_steps(inputs: dict, case: str, mesh_shape: tuple) -> dict:
    """Pi0FAST's standard step (8-bit AdamW, an active clip, accumulation 2)
    for two micro-steps on the mesh, each batch coordinate on its rows of the
    global micro-batches."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0fast import model
    from intact_tpu_torch.parallel import MeshConfig, collectives, local_rows, make_mesh
    from intact_tpu_torch.parallel.sharding import Sharded, shard_tree
    from intact_tpu_torch.train import optim8bit
    from intact_tpu_torch.train.optim import OptimizerConfig, make_optimizer
    from intact_tpu_torch.train.train_step import init_train_state, make_train_step

    optim8bit.MIN_QUANT_ELEMS = inputs["min_quant"]
    spec = inputs["fast"][case]
    cfg = fast_config(*spec["config"])
    policy = cm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
    mesh = make_mesh(MeshConfig(*mesh_shape))
    params = shard_tree(cm.unflatten_paths(dist_child._flat_clone(spec["params"])), mesh, consume=True,
                        heads=model.tensor_heads(cfg))
    tx, _ = make_optimizer(OptimizerConfig(**spec["opt"]), None, mesh=mesh)
    state = init_train_state(params, tx, seed=0)
    step = make_train_step(lambda p, rng, b, n, t: model.compute_loss(p, rng, b, cfg, policy), tx)
    collectives.reset()
    losses, accs, norms = [], [], []
    for batch in spec["batches"]:
        state, metrics = step(state, local_rows(batch, mesh.batch_index, mesh.batch_size))
        losses.append(metrics["l2_loss"].item())
        accs.append(metrics["token_accuracy"].item())
        norms.append([metrics["grad_norm"].item(), metrics["param_norm"].item()])
    counts = collectives.counts()
    fsdp_split = sorted(k for k, v in cm.flatten_paths(state.params).items() if isinstance(v, Sharded) and v.fsdp_split)
    return {"losses": losses, "accs": accs, "norms": norms, "params": dist_child.whole_tree(state.params),
            "split": tp_child.tensor_split(state.params), "fsdp_split": fsdp_split, "partial": sorted(tx.partial),
            "collectives": counts, "batch_index": mesh.batch_index}


def cross_entropy(inputs: dict, mesh_shape: tuple) -> dict:
    """`tensor_parallel.vocab_cross_entropy` on this rank's columns of each
    case's logits (padded past the vocabulary with large values) and its
    gradient against an upstream gradient -> the rank's nll, its columns'
    gradient and the collectives one call ran."""
    from intact_tpu_torch.parallel import MeshConfig, collectives, make_mesh
    from intact_tpu_torch.parallel import tensor as tensor_parallel

    mesh = make_mesh(MeshConfig(*mesh_shape))
    tp = tensor_parallel.TensorParallel(mesh.groups["tensor"], mesh.tensor, mesh.tensor_index)
    out = {}
    for name, (logits, targets, vocab, upstream) in inputs["ce"].items():
        n = logits.shape[-1] // mesh.tensor
        local = logits[..., tp.columns(n)].clone().requires_grad_()
        collectives.reset()
        nll = tensor_parallel.vocab_cross_entropy(local, targets, tp, vocab)
        counts = collectives.counts()
        (grad,) = torch.autograd.grad(nll, local, upstream)
        out[name] = {"nll": nll.detach(), "grad": grad, "collectives": counts, "index": mesh.tensor_index}
    return out


def _fused_state(inputs: dict, mesh, dtype):
    """The fused step's state from the tiny Pi0 params (`dtype`) on the mesh:
    this rank's tensor slices, whole over fsdp, moments in the one-card layout."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0 import model
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.parallel.sharding import shard_tree
    from intact_tpu_torch.train import fused_joint as fj

    params = cm.unflatten_paths({k: v.to(dtype) for k, v in dist_child._flat_clone(inputs["params"]).items()})
    if mesh.size > 1:
        params = shard_tree(params, mesh, consume=True, heads=model.tensor_heads(Pi0Config.tiny()), over_fsdp=False)
    return fj.init_fused_state(params, seed=7, block_size=FUSED_BLOCK, min_quant_elems=FUSED_MIN_QUANT, mesh=mesh)


def fused_steps(inputs: dict, mesh_shape: tuple) -> dict:
    """Two fused steps (fp32, SR off, the kernel's plain version, a delayed
    clip active at the second) on the mesh, each batch coordinate on its rows
    of the batch and of the JAX step's draws."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.parallel import MeshConfig, collectives, local_rows, make_mesh
    from intact_tpu_torch.train import fused_joint as fj
    from intact_tpu_torch.train.optim import OptimizerConfig

    spec = inputs["fused"]
    mesh = make_mesh(MeshConfig(*mesh_shape))
    state = _fused_state(spec, mesh, torch.float32)
    step = fj.make_fused_joint_step(Pi0Config.tiny(), OptimizerConfig(**spec["opt"]), cm.FP32_POLICY,
                                    block_size=FUSED_BLOCK, stochastic_rounding=False, scale_mode="exact", mesh=mesh)
    rows_updated, real = [], fj.fused_adam_rows
    fj.fused_adam_rows = lambda p, *a, **k: (rows_updated.append(p.shape[1]), real(p, *a, **k))[1]
    collectives.reset()
    metrics = []
    for i in range(2):
        rows = local_rows({**spec["batch"], "noise": spec["noise"][i], "time": spec["time"][i]}, mesh.batch_index,
                          mesh.batch_size)
        state, m = step(state, rows, noise=rows.pop("noise"), time=rows.pop("time"))
        metrics.append((m["l2_loss"].item(), m["grad_norm"].item(), m["clip_factor"].item()))
    counts = collectives.counts()
    fj.fused_adam_rows = real
    mu, nu = fj.global_moments(state, mesh, block_size=FUSED_BLOCK)
    return {"metrics": metrics, "params": dist_child.whole_tree(state.params), "mu": cm.flatten_paths(mu),
            "nu": cm.flatten_paths(nu), "split": tp_child.tensor_split(state.params), "collectives": counts,
            "local_rows": state.mu["vlm"]["blocks"]["q"].shape[1], "batch_index": mesh.batch_index,
            "model_index": mesh.model_index, "kernel_rows": sum(rows_updated)}


def _fed_grads(spec: dict, flat: dict, partial: frozenset, mesh) -> dict:
    """This rank's share of one card's gradient {path: whole gradient}, in
    the leaf's dtype (as autograd gives it): a tensor slice's part, a leaf
    replicated over tensor whole (one whose use is partial on tensor index 0
    alone, zeros elsewhere: their sum over tensor is then one card's)."""
    from intact_tpu_torch.parallel.sharding import Sharded, held, take_slice

    out = {}
    for path, g in spec.items():
        leaf = flat[path]
        g = g.to(held(leaf).dtype)
        if isinstance(leaf, Sharded):
            out[path] = take_slice(g, leaf).clone()
        elif path in partial and mesh.tensor_index != 0:
            out[path] = torch.zeros_like(g)
        else:
            out[path] = g.clone()
    return out


def fed_update(inputs: dict, mesh_shape: tuple) -> dict:
    """Two fused updates of every leaf (bf16 masters, stochastic rounding,
    8-bit moments at block 8, the kernel's plain version) fed one card's
    gradients: on the mesh (this rank's share of them: `_fed_grads`, the
    same on every batch coordinate) and on one rank in this process, by the
    step's own updater -> both sides' params and gathered moments."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.parallel import MeshConfig, make_mesh
    from intact_tpu_torch.parallel import tensor as tensor_parallel
    from intact_tpu_torch.parallel.mesh import single_rank_mesh
    from intact_tpu_torch.train import fused_joint as fj
    from intact_tpu_torch.train.optim import OptimizerConfig

    spec = inputs["fed"]
    cfg = Pi0Config.tiny()
    opt = OptimizerConfig(**inputs["fused"]["opt"])
    out = {}
    for name, mesh in (("ranks", make_mesh(MeshConfig(*mesh_shape))), ("one", single_rank_mesh())):
        state = _fused_state(inputs["fused"], mesh, torch.bfloat16)
        params = state.params
        flat = cm.flatten_paths(params)
        partial = tensor_parallel.partial_paths(flat) if mesh.tensor > 1 else frozenset()
        for step, grads in enumerate(spec["grads"]):
            grads = _fed_grads(grads, flat, partial, mesh)
            ss = torch.zeros(1, dtype=torch.float32)
            hyp = torch.tensor([0.1 * (step + 1), 0.001 * (step + 1), 1e-2, 0.5], dtype=torch.float32)
            upd = fj._Updater(hyp, opt, ss, stochastic=True, block_size=FUSED_BLOCK, use_kernel=True,
                              scale_mode="exact", apply_updates=True, mesh=mesh, partial=partial)
            for tower in ("vlm", "expert"):
                blocks = params[tower]["blocks"]
                pack = fj.TrunkPack(blocks, FUSED_BLOCK)
                paths = [f"{tower}/blocks/" + "/".join(p) for p, _ in fj.tree_items(blocks)]
                for layer in range(cfg.vlm.depth):
                    upd.trunk_rows(pack, blocks, [grads[p][layer] for p in paths], state.mu[tower]["blocks"],
                                   state.nu[tower]["blocks"], layer, 1000 * step + layer, f"{tower}/blocks/")
            rest = {k: v for k, v in params.items() if k not in ("vlm", "expert", "vlm_embed")}
            upd.small_tree(rest, [grads["/".join(p)] for p, _ in fj.tree_items(rest)],
                           {k: state.mu[k] for k in rest}, {k: state.nu[k] for k in rest}, 77 + step)
            upd.total_ss()
        mu, nu = fj.global_moments(state, mesh, block_size=FUSED_BLOCK)
        out[name] = {"params": dist_child.whole_tree(params), "mu": cm.flatten_paths(mu), "nu": cm.flatten_paths(nu),
                     "split": tp_child.tensor_split(params), "local_rows": state.mu["vlm"]["blocks"]["q"].shape[1]}
    return out


def _trainer(recipe: Path, mesh_shape: tuple, workdir: Path, name: str, **overrides):
    from intact_tpu_torch.train.trainer import Trainer

    data, fsdp, tensor = mesh_shape
    return Trainer(dist_child.recipe_config(recipe, **{
        "mesh.data": data, "mesh.fsdp": fsdp, "mesh.tensor": tensor, "per_device_batch_size": 2,
        "global_batch_size": 2 * data * fsdp, "n_updates": 1, "eval_freq": 1, "eval_size": 2 * data * fsdp,
        "log_dir": workdir / name, **overrides}), device="cpu")


def trainer_run(inputs: dict, workdir: Path, which: str, mesh_shape: tuple) -> dict:
    """The recipe's Trainer ("fast": pi0fast_finetune_bridge.yaml at
    pi0fast_tiny; "fused": pi0_finetune_bridge_1chip.yaml at the tiny Pi0,
    bf16 masters with stochastic rounding) on the mesh: one update with
    validation, the last update saved from the ranks -> the rank's gathered
    state and the save."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.parallel import collectives

    dist_child.tiny_pipeline()
    recipe, extra = (FAST_RECIPE, {"model_cfg.type": "pi0fast_tiny"}) if which == "fast" else (FUSED_RECIPE, {})
    trainer = _trainer(recipe, mesh_shape, workdir, f"trainer_{which}", **extra)
    validations, real_validate = [], trainer.validate
    trainer.validate = lambda: validations.append(real_validate()) or validations[-1]
    collectives.reset()
    trainer.train()
    if which == "fused":
        fields = trainer._global_fields()
        state = cm.flatten_paths({k: fields[k] for k in ("mu", "nu")})
    else:
        state = cm.flatten_paths(trainer.tx.global_state(trainer.state.opt_state, trainer.state.params, keep=True))
    return {"params": dist_child.whole_tree(trainer.state.params), "state": state, "validations": validations,
            "saved": str(Path(trainer.ckpt_root) / "step_1"), "split": tp_child.tensor_split(trainer.state.params),
            "mesh": trainer.mesh.shape, "collectives": collectives.counts()}


def resume_one_rank_save(inputs: dict, workdir: Path, mesh_shape: tuple) -> dict:
    """The test's one-rank Pi0FAST save resumed on the mesh: the ranks'
    gathered params and optimizer state against the saved files, and the
    rank's tensor slices."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.train import checkpoint as ckpt

    dist_child.tiny_pipeline()
    saved = Path(inputs["fast_save"])
    trainer = _trainer(FAST_RECIPE, mesh_shape, workdir, "resumed_fast", **{
        "model_cfg.type": "pi0fast_tiny", "load_from_checkpoint": saved})
    want_params = torch.load(saved / ckpt.PARAMS_FILE, weights_only=True)
    want_state = cm.flatten_paths(torch.load(saved / ckpt.STATE_FILE, weights_only=True)["opt_state"])
    got_state = cm.flatten_paths(trainer.tx.global_state(trainer.state.opt_state, trainer.state.params, keep=True))
    params_equal = all(torch.equal(v, want_params[k]) for k, v in dist_child.whole_tree(trainer.state.params).items())
    state_equal = set(got_state) == set(want_state) and all(
        torch.equal(v, want_state[k]) if isinstance(v, torch.Tensor) else v == want_state[k]
        for k, v in got_state.items())
    return {"params_equal": params_equal, "state_equal": state_equal, "cnt_update": trainer.cnt_update,
            "split": tp_child.tensor_split(trainer.state.params)}


def _run(name: str, rank: int, world: int, port: int, workdir: str, tasks) -> None:
    from intact_tpu_torch.parallel import distributed

    dist_child._join(rank, world, port)
    workdir = Path(workdir)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    result = {key: fn(inputs, workdir) for key, fn in tasks}
    torch.save(result, workdir / f"{name}_rank{rank}.pt")
    distributed.destroy()


def pair(rank: int, world: int, port: int, workdir: str) -> None:
    """Two ranks, (1, 1, 2): Pi0FAST's step at both vocabularies, the cross
    entropy at t = 2, the fused step and its fed update, both trainers and
    the one-rank save resumed."""
    mesh = (1, 1, 2)
    _run("pair", rank, world, port, workdir, [
        ("fast_even", lambda i, w: fast_steps(i, "tiny-even", mesh)),
        ("fast_ragged", lambda i, w: fast_steps(i, "tiny-ragged", mesh)),
        ("ce", lambda i, w: cross_entropy(i, mesh)),
        ("fused", lambda i, w: fused_steps(i, mesh)),
        ("fed", lambda i, w: fed_update(i, mesh)),
        ("trainer_fast", lambda i, w: trainer_run(i, w, "fast", mesh)),
        ("trainer_fused", lambda i, w: trainer_run(i, w, "fused", mesh)),
        ("resumed_fast", lambda i, w: resume_one_rank_save(i, w, mesh)),
    ])


def quad(rank: int, world: int, port: int, workdir: str) -> None:
    """Four ranks: Pi0FAST's step at (1, 2, 2) and at (1, 1, 4) (its 4-head
    variant), the cross entropy at t = 4, the fused step at (1, 2, 2) and
    (2, 1, 2), the fed update at (1, 2, 2)."""
    _run("quad", rank, world, port, workdir, [
        ("fast_even_1x2x2", lambda i, w: fast_steps(i, "tiny-even", (1, 2, 2))),
        ("fast_ragged_1x2x2", lambda i, w: fast_steps(i, "tiny-ragged", (1, 2, 2))),
        ("fast_even_1x1x4", lambda i, w: fast_steps(i, "tiny4-even", (1, 1, 4))),
        ("fast_ragged_1x1x4", lambda i, w: fast_steps(i, "tiny4-ragged", (1, 1, 4))),
        ("ce_1x1x4", lambda i, w: cross_entropy(i, (1, 1, 4))),
        ("fused_1x2x2", lambda i, w: fused_steps(i, (1, 2, 2))),
        ("fused_2x1x2", lambda i, w: fused_steps(i, (2, 1, 2))),
        ("fed_1x2x2", lambda i, w: fed_update(i, (1, 2, 2))),
    ])
