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
FAST_RECIPE = REPO / "config/train/pi0fast_finetune_bridge.yaml"


def _join(rank: int, world: int, port: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from intact_tpu_torch.parallel import distributed

    distributed.initialize("cpu")


def tiny_pipeline(min_quant_elems: int = 1024, vision=None) -> None:
    """The trainer's model JSON read as Pi0Config.tiny() (its
    train_expert_only kept; `vision` replaces its SigLIP config), 8-bit
    moments from `min_quant_elems` elements."""
    from intact_tpu_torch.config import pipeline
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.train import optim8bit

    optim8bit.MIN_QUANT_ELEMS = min_quant_elems
    tiny = Pi0Config.tiny() if vision is None else dataclasses.replace(Pi0Config.tiny(), vision=vision)
    pipeline.pi0_config_from_json = lambda d: dataclasses.replace(
        tiny, train_expert_only=bool(d.get("train_expert_only", False)))


def quad_vision():
    """SigLIP at width 30 (2 heads of 15): its leaves do not split over 4
    ranks, so the four-rank recipe holds them whole beside the split VLM."""
    from intact_tpu_torch.models.siglip import tiny_test_config

    return dataclasses.replace(tiny_test_config(), width=30, num_heads=2)


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

def family(name: str):
    """(model module, tiny config) of a standard-step task's family."""
    if name in ("pi0", "expert"):
        from intact_tpu_torch.models.pi0 import model
        from intact_tpu_torch.models.pi0.config import Pi0Config

        return model, dataclasses.replace(Pi0Config.tiny(), train_expert_only=name == "expert")
    if name == "fast":
        from intact_tpu_torch.models.pi0fast import model
        from intact_tpu_torch.models.pi0fast.config import Pi0FASTConfig

        return model, Pi0FASTConfig.tiny()
    from intact_tpu_torch.models.mvla import model
    from intact_tpu_torch.models.mvla.config import MVLAConfig

    return model, MVLAConfig.tiny()


def whole_tree(params) -> dict:
    """{path: whole leaf} of a rank's params, the split leaves gathered."""
    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.parallel.sharding import Sharded, gather_leaf

    return {k: (gather_leaf(v.local, v) if isinstance(v, Sharded) else v).detach().clone()
            for k, v in flatten_paths(params).items()}


def record_grads(tx) -> dict:
    """Wrap the optimizer's apply to record {path: elements of the gradient
    it was handed} (a split leaf's arrives as its slice)."""
    from intact_tpu_torch.models.common import flatten_paths

    sizes, real = {}, tx.apply

    def apply(grads, state, params, sink):
        sizes.update({k: g.numel() for k, g in flatten_paths(grads).items()})
        return real(grads, state, params, sink)

    tx.apply = apply
    return sizes


def held_sizes(state, grads: dict) -> dict:
    """{path: (whole elements, the rank's param, accumulator and moment
    elements, its moments' scales, its gradient's elements)} of the trainable
    split leaves, read from the state and the recorded gradients; None for a
    trainable leaf held whole."""
    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.parallel.sharding import Sharded

    params, opt = flatten_paths(state.params), state.opt_state
    out = {}
    for k, mu in opt["mu"].items():
        p = params[k]
        if not isinstance(p, Sharded):
            out[k] = None
            continue
        codes = [m["q"] if isinstance(m, dict) else m for m in (mu, opt["nu"][k])]
        scales = [m["scale"].numel() if isinstance(m, dict) else 0 for m in (mu, opt["nu"][k])]
        out[k] = (p.numel(), p.local.numel(), opt["acc"][k].numel() if "acc" in opt else 0,
                  [c.numel() for c in codes], scales, grads[k])
    return out


def standard_steps(inputs: dict, task: str, data: int, fsdp: int, one_rank: bool = False, same_rows: bool = False,
                   rules=None) -> dict:
    """A standard-step task of the inputs (a family's params, freeze mask,
    optimizer, micro-batches and draws) on a data x fsdp mesh, ZeRO-3 over
    fsdp (the params cut by `rules`, DEFAULT_RULES by default), each rank on
    its rows of the global micro-batches (with `same_rows` every rank on all
    of them); with `one_rank` on one rank without a group, on the whole
    micro-batches."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.parallel import MeshConfig, collectives, local_rows, make_mesh
    from intact_tpu_torch.parallel.mesh import single_rank_mesh
    from intact_tpu_torch.parallel.sharding import shard_tree
    from intact_tpu_torch.train.optim import OptimizerConfig, make_optimizer
    from intact_tpu_torch.train.train_step import init_train_state, make_train_step

    spec = inputs["std"][task]
    model, cfg = family(spec["family"])
    policy = cm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
    mesh = single_rank_mesh() if one_rank else make_mesh(MeshConfig(data=data, fsdp=fsdp))
    collectives.reset()
    params = cm.unflatten_paths(_flat_clone(spec["params"]))
    if mesh.fsdp > 1:
        params = shard_tree(params, mesh, consume=True, rules=rules)
    mask = cm.unflatten_paths(spec["mask"]) if spec["mask"] is not None else None
    tx, _ = make_optimizer(OptimizerConfig(**spec["opt"]), mask, mesh=mesh)
    grads = record_grads(tx)
    state = init_train_state(params, tx, seed=0)
    step = make_train_step(lambda p, rng, b, n, t: model.compute_loss(p, rng, b, cfg, policy, noise=n, time=t), tx)
    losses, norms = [], []
    for i, batch in enumerate(spec["batches"]):
        rows = {**batch, **({"noise": spec["noise"][i], "time": spec["time"][i]} if spec["noise"] else {})}
        if not (one_rank or same_rows):
            rows = local_rows(rows, mesh.rank, mesh.size)
        state, metrics = step(state, rows, noise=rows.pop("noise", None), time=rows.pop("time", None))
        losses.append(metrics["l2_loss"].item())
        norms.append((metrics["grad_norm"].item(), metrics["param_norm"].item()))
    counts = collectives.counts()  # the steps', before the state is gathered
    sizes = held_sizes(state, grads)
    moments = tx.global_state(state.opt_state, state.params, keep=True)
    return {"losses": losses, "norms": norms, "params": whole_tree(state.params), "mu": cm.flatten_paths(moments["mu"]),
            "nu": cm.flatten_paths(moments["nu"]), "held": sizes, "collectives": counts}


def gather_layer_check(rank: int, world: int) -> dict:
    """GatherLayer alone on mixed dtypes: one layer of a stacked bf16 leaf
    split on its last dim, of stacked int8 codes split on a middle one and of
    a stacked fp32 leaf split on its first, in one bucket, and an unstacked
    fp32 leaf alone. The gathers against each leaf's own all-gather, and the
    reduce-scatter of the trainable leaves' gradients against a
    reduce-scatter per leaf, bit for bit; the unpacked leaves' addresses."""
    from intact_tpu_torch.parallel import MeshConfig, collectives, make_mesh
    from intact_tpu_torch.parallel.sharding import GatherLayer, all_gather_bytes, shard_leaf

    mesh = make_mesh(MeshConfig(data=1, fsdp=world))
    gen = torch.Generator().manual_seed(3)
    whole = {"blocks/attn/o/kernel": torch.randn(3, 5, 6, generator=gen).to(torch.bfloat16),
             "blocks/mlp/gate/kernel_q": torch.randint(-127, 128, (3, 6, 4, 3), generator=gen).to(torch.int8),
             "blocks/attn/q/kernel": torch.randn(3, 6, 5, generator=gen),
             "embed/embedding": torch.randn(8, 10, generator=gen)}
    rules = [(r".*/o/kernel$", (None, None, "fsdp")), (r".*kernel_q$", (None, "fsdp", None, None)),
             (r".*/q/kernel$", (None, "fsdp", None)), (r".*embedding$", ("fsdp", None))]
    leaves = [shard_leaf(k, v, mesh, rules=rules) for k, v in whole.items()]
    names = list(whole)
    buckets = ((1, [0, 1, 2]), (None, [3]))
    out = {}
    for index, members in buckets:
        group = [leaves[j] for j in members]
        collectives.reset()
        got = GatherLayer.apply(group, index, *(s.local for s in group))
        calls = collectives.counts()["bucket_all_gather"]
        per_leaf = []
        for s in group:
            x = s.local if index is None else s.local[index]
            per_leaf.append(torch.cat(list(all_gather_bytes(x, s.group, s.parts).unbind(0)),
                                      dim=s.dim - (s.local.ndim - x.ndim)))
        want = [whole[names[j]] if index is None else whole[names[j]][index] for j in members]
        out[f"gather_{index}"] = {"per_leaf": all(torch.equal(a, b) for a, b in zip(got, per_leaf)),
                                  "whole": all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want)),
                                  "contiguous": all(a.is_contiguous() for a in got),
                                  "aligned": all(a.data_ptr() % 16 == 0 for a in got), "calls": calls}
    # the backward: the bf16 and fp32 leaves train, the int8 codes are a constant of the loss
    views = [s.with_local(s.local.detach().requires_grad_(s.local.is_floating_point())) for s in leaves]
    shapes = {0: (5, 6), 2: (6, 5), 3: (8, 10)}
    weights = {(r, j): torch.randn(shape, generator=torch.Generator().manual_seed(10 * r + j))
               for r in range(world) for j, shape in shapes.items()}
    collectives.reset()
    with torch.enable_grad():
        w_o, _, w_q = GatherLayer.apply(views[:3], 1, *(v.local for v in views[:3]))
        (w_e,) = GatherLayer.apply(views[3:], None, views[3].local)
        loss = sum((w.float() * weights[rank, j]).sum() for j, w in ((0, w_o), (2, w_q), (3, w_e)))
        loss.backward()
    rs_calls = collectives.counts()["bucket_reduce_scatter"]
    equal = True
    for j, index in ((0, 1), (2, 1), (3, None)):
        s = leaves[j]
        dim = s.dim - (0 if index is None else 1)
        g = weights[rank, j].to(s.dtype).to(torch.float32)  # the whole gradient as autograd forms it
        pieces = g.chunk(world, dim=dim)
        part = torch.empty(pieces[0].numel())
        collectives.reduce_scatter(part, torch.cat([c.reshape(-1) for c in pieces]), s.group)
        want = torch.zeros_like(s.local)
        (want if index is None else want[index]).copy_(part.view(pieces[0].shape))
        equal = equal and views[j].grad.dtype == s.dtype and torch.equal(views[j].grad, want)
    out["reduce_scatter"] = {"equal": equal, "frozen": views[1].grad is None, "calls": rs_calls}
    return out


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


def gathered_opt_state(trainer) -> dict:
    """{path: leaf} of a trainer's optimizer state in the one-rank layout, kept on every rank."""
    from intact_tpu_torch.models import common as cm

    return cm.flatten_paths(trainer.tx.global_state(trainer.state.opt_state, trainer.state.params, keep=True))


def checkpoint_round_trip(inputs: dict, workdir: Path, same_rows: bool) -> dict:
    """Resume the test's one-rank checkpoint on two fsdp ranks, then take one
    update and save it from the ranks: each rank on its own rows of the
    global batch, or (`same_rows`) every rank on the whole batch, whose
    reduced gradient is then one rank's bit for bit."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.parallel import local_rows
    from intact_tpu_torch.train import checkpoint as ckpt
    from intact_tpu_torch.train.trainer import Trainer

    tiny_pipeline()
    saved_dir = Path(inputs["ckpt_step"])
    log_dir = workdir / ("two_same" if same_rows else "two")
    trainer = Trainer(recipe_config(JOINT_RECIPE, **inputs["ckpt_overrides"], **{
        "mesh.fsdp": 2, "per_device_batch_size": 2, "log_dir": log_dir, "load_from_checkpoint": saved_dir}),
        device="cpu")
    saved_fields = torch.load(saved_dir / ckpt.STATE_FILE, weights_only=True)
    saved_params = torch.load(saved_dir / ckpt.PARAMS_FILE, weights_only=True)
    gathered = gathered_opt_state(trainer)
    want = cm.flatten_paths(saved_fields["opt_state"])
    restored_equal = (set(gathered) == set(want) and all(
        torch.equal(v, want[k]) if isinstance(v, torch.Tensor) else v == want[k] for k, v in gathered.items())
        and all(torch.equal(v, saved_params[k]) for k, v in whole_tree(trainer.state.params).items()))
    grads = record_grads(trainer.tx)
    rows = {**inputs["ckpt_batch"], "noise": inputs["ckpt_noise"], "time": inputs["ckpt_time"]}
    if not same_rows:
        rows = local_rows(rows, trainer.mesh.rank, trainer.mesh.size)
    noise, time = rows.pop("noise"), rows.pop("time")
    trainer.state, metrics = trainer.train_step(trainer.state, rows, noise=noise, time=time)
    trainer.cnt_update += 1
    path = trainer.save()
    out = {"restored_equal": restored_equal, "saved": str(path), "params": whole_tree(trainer.state.params),
           "opt_state": gathered_opt_state(trainer), "loss": metrics["l2_loss"].item(),
           "held": held_sizes(trainer.state, grads),
           # what the trainer hands its save: the gathered split leaves on process 0 only
           "fields_dropped": sum(v is None for v in cm.flatten_paths(trainer._global_fields()["opt_state"]).values())}
    if not same_rows:  # the trainer's episodes: this rank's shard of the synthetic stream
        frames, data = [], iter(trainer.train_data)
        while len(frames) < inputs["shard_frames"]:
            frames += frame_keys(next(data))
        out["frames"] = frames[:inputs["shard_frames"]]
    return out


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
        mesh = f"{data}x{fsdp}"
        result[f"std_{mesh}"] = standard_steps(inputs, "pi0", data, fsdp)
        result[f"expert_{mesh}"] = standard_steps(inputs, "expert", data, fsdp)
        result[f"same_{mesh}"] = {"ranks": standard_steps(inputs, "pi0_same", data, fsdp, same_rows=True),
                                  "one": standard_steps(inputs, "pi0_same", 1, 1, one_rank=True)}
    for name in ("fast", "mvla"):
        result[f"{name}_1x2"] = standard_steps(inputs, name, 1, 2)
    # no leaf split: rules that split nothing, and fp32 moments; the fsdp ranks count only the
    # replicated leaves, on rank 0
    from intact_tpu_torch.train import optim8bit

    optim8bit.MIN_QUANT_ELEMS = 10**9
    result["std_unsplit"] = {"ranks": standard_steps(inputs, "pi0", 1, 2, rules=[(r".*", ())]),
                             "one": standard_steps(inputs, "pi0", 1, 1, one_rank=True)}
    result["gather_layer"] = gather_layer_check(rank, world)
    tiny_pipeline()
    for name, (data, fsdp, same, bf16) in {"fused_same_2x1": (2, 1, True, True), "fused_same_1x2": (1, 2, True, True),
                                           "fused_rows_2x1": (2, 1, False, False)}.items():
        result[name] = fused_steps(inputs, data, fsdp, same, bf16)
    result["ckpt"] = checkpoint_round_trip(inputs, workdir, same_rows=False)
    result["ckpt_same"] = checkpoint_round_trip(inputs, workdir, same_rows=True)
    torch.save(result, workdir / f"pair_rank{rank}.pt")
    distributed.destroy()


# ---------------------------------------------------------------------------
# four ranks: the repo's fsdp-4 recipes, their mesh unchanged
# ---------------------------------------------------------------------------

def quad(rank: int, world: int, port: int, workdir: str) -> None:
    """config/train/pi0_finetune_bridge.yaml (SigLIP at width 30: held whole)
    and config/train/pi0fast_finetune_bridge.yaml at pi0fast_tiny, each with
    its mesh (data -1, fsdp 4) at world 4: one update with validation and the
    last update's save."""
    from intact_tpu_torch.parallel import collectives, distributed
    from intact_tpu_torch.train.trainer import Trainer

    _join(rank, world, port)
    workdir = Path(workdir)
    tiny_pipeline(vision=quad_vision())
    result = {}
    for name, recipe, extra in (("pi0", JOINT_RECIPE, {}),
                                ("fast", FAST_RECIPE, {"model_cfg.type": "pi0fast_tiny"})):
        cfg = recipe_config(recipe, per_device_batch_size=2, global_batch_size=8, n_updates=1, eval_freq=1,
                            eval_size=8, log_dir=workdir / f"quad_{name}", **extra)
        trainer = Trainer(cfg, device="cpu")
        grads = record_grads(trainer.tx)
        losses, validations = [], []
        real_step, real_validate = trainer.train_step, trainer.validate

        def step(state, batch, real_step=real_step, losses=losses):
            state, metrics = real_step(state, batch)
            losses.append(metrics["l2_loss"].item())
            return state, metrics

        trainer.train_step = step
        trainer.validate = lambda real_validate=real_validate, validations=validations: (
            validations.append(real_validate()) or validations[-1])
        collectives.reset()
        trainer.train()
        result[name] = {"mesh": trainer.mesh.shape, "accum": trainer.opt_cfg.grad_accumulation_steps,
                        "losses": losses, "validations": validations, "params": whole_tree(trainer.state.params),
                        "held": held_sizes(trainer.state, grads), "collectives": collectives.counts(),
                        "ckpt_root": str(trainer.ckpt_root), "name": cfg.name}
        del trainer, real_step, real_validate
    torch.save(result, workdir / f"quad_rank{rank}.pt")
    distributed.destroy()
