"""The rank processes of tests/test_torch_tensor_parallel_ar.py, spawned with
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

FAMILIES = ("pi0fast", "spatialvla", "magma")
# the greedy decode's logits each family's module computes, per step
LOGITS_FN = {"pi0fast": "_logits", "spatialvla": "logits", "magma": "logits"}


def config(family: str, vocab: int):
    """The family's tiny config with its vocabulary of `vocab` rows (Magma's
    image placeholder at the last row when the stock one does not fit)."""
    from intact_tpu_torch.models.magma.config import MagmaConfig
    from intact_tpu_torch.models.pi0fast.config import Pi0FASTConfig
    from intact_tpu_torch.models.spatialvla.config import SpatialVLAConfig

    if family == "pi0fast":
        cfg = Pi0FASTConfig.tiny()
        return dataclasses.replace(cfg, vlm=dataclasses.replace(cfg.vlm, vocab_size=vocab))
    if family == "spatialvla":
        cfg = SpatialVLAConfig.tiny()
        return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, vocab_size=vocab))
    cfg = MagmaConfig.tiny()
    image_id = cfg.image_token_id if cfg.image_token_id < vocab else vocab - 1
    return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, vocab_size=vocab), image_token_id=image_id)


def module(family: str):
    import importlib

    return importlib.import_module(f"intact_tpu_torch.models.{family}.model")


def trunk(family: str):
    """The module whose `LOGITS_FN` the greedy decode calls."""
    from intact_tpu_torch.models import gemma2, llama

    return {"pi0fast": module("pi0fast"), "spatialvla": gemma2, "magma": llama}[family]


def tokens(family: str, params, inputs: dict, cfg, policy) -> torch.Tensor:
    """The family's greedy tokens through its model entry point."""
    mod = module(family)
    if family == "pi0fast":
        return mod.sample_actions(params, None, inputs["images"], inputs["img_masks"], inputs["lang_tokens"],
                                  inputs["lang_masks"], inputs["state"], cfg, policy, return_tokens=True).long()
    if family == "spatialvla":
        return mod.predict_action_tokens(params, inputs["images"], inputs["depth"], inputs["lang_tokens"],
                                         inputs["lang_masks"], cfg, policy)
    return mod.generate(params, inputs["images"], inputs["tokens"], inputs["masks"], cfg, policy)


def decode(spec: dict, mesh=None, quantize: bool = False) -> dict:
    """A case's tokens and each step's logits (this rank's columns of them)
    on `mesh` (its batch coordinate's rows) or on one rank without one, in
    fp32 compute, int8 with `quantize`. -> {"tokens", "logits" [step] [B, V
    or the rank's columns], "split": the tensor-split paths}."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.parallel import local_rows
    from intact_tpu_torch.parallel.sharding import shard_tree

    family, vocab = spec["case"]
    cfg = config(family, vocab)
    params = cm.unflatten_paths(dist_child._flat_clone(spec["params"]))
    if quantize:
        params = cm.quantize_params(params, consume=True)
    inputs = spec["inputs"]
    if mesh is not None:
        params = shard_tree(params, mesh, consume=True, heads=module(family).tensor_heads(cfg))
        inputs = local_rows(inputs, mesh.batch_index, mesh.batch_size)
    holder, name = trunk(family), LOGITS_FN[family]
    real, steps = getattr(holder, name), []

    def recorded(*args, **kw):
        out = real(*args, **kw)
        steps.append(out.clone())
        return out

    setattr(holder, name, recorded)
    try:
        out = tokens(family, params, inputs, cfg, cm.FP32_POLICY)
    finally:
        setattr(holder, name, real)
    return {"tokens": out, "logits": steps, "split": tensor_split(params)}


def tensor_split(params) -> list[str]:
    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.parallel.sharding import Sharded

    return sorted(k for k, v in flatten_paths(params).items() if isinstance(v, Sharded) and v.tensor is not None)


def cases(inputs: dict, mesh_shape: tuple, keys) -> dict:
    """Each case of `keys` in fp32 and int8 on the mesh -> {key: {"fp32",
    "int8": decode's result, the rank's coordinates and collectives}}."""
    from intact_tpu_torch.parallel import MeshConfig, collectives, make_mesh

    mesh = make_mesh(MeshConfig(*mesh_shape))
    out = {}
    for key in keys:
        res = {"batch_index": mesh.batch_index, "tensor_index": mesh.tensor_index}
        for precision, quantize in (("fp32", False), ("int8", True)):
            collectives.reset()
            res[precision] = decode(inputs["cases"][key], mesh, quantize)
            res[precision]["collectives"] = collectives.counts()
        out[key] = res
    return out


def switched_wrapper(inputs: dict, mesh_shape: tuple) -> dict:
    """The server role's int8 Magma wrapper at the mesh, its serving group
    over the ranks: rank 0 switches it to a checkpoint saved in the one-rank
    layout (every rank restores its tensor slice) and decodes the fused
    rows -> rank 0's tokens, and every rank's tensor-split paths."""
    import numpy as np

    from intact_tpu_torch.parallel import MeshConfig, make_mesh
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    mesh = make_mesh(MeshConfig(*mesh_shape))
    spec = inputs["wrapper"]
    wrapper = make_policy_wrapper(spec["config"], device="cpu", mesh=mesh)
    wrapper.policy = dataclasses.replace(wrapper.policy, compute_dtype=torch.float32)
    ids = None
    if mesh.rank == 0:
        wrapper.switch_model(spec["checkpoint"])
        ids = wrapper.generate_tokens(np.asarray(spec["images"]), spec["tasks"])
        wrapper.group.stop()
    else:
        wrapper.group.follow()
    return {"ids": ids, "split": tensor_split(wrapper.params), "generation": wrapper.model_generation}


def _run(name: str, rank: int, world: int, port: int, workdir: str, tasks) -> None:
    from intact_tpu_torch.parallel import distributed

    dist_child._join(rank, world, port)
    workdir = Path(workdir)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    result = {key: fn(inputs) for key, fn in tasks}
    torch.save(result, workdir / f"{name}_rank{rank}.pt")
    distributed.destroy()


def pair(rank: int, world: int, port: int, workdir: str) -> None:
    """Two ranks, (1, 1, 2): every case, divisible and ragged vocabularies,
    and the Magma wrapper switched to a one-rank checkpoint."""
    mesh = (1, 1, 2)
    _run("pair", rank, world, port, workdir, [
        ("cases", lambda i: cases(i, mesh, i["cases"])),
        ("wrapper", lambda i: switched_wrapper(i, mesh)),
    ])


def quad(rank: int, world: int, port: int, workdir: str) -> None:
    """Four ranks: (1, 1, 4) on every case (Gemma2's and LLaMA's two tiny K/V
    heads held whole), then (1, 2, 2) on the divisible ones (each tensor
    slice split further over fsdp, two batch coordinates)."""
    _run("quad", rank, world, port, workdir, [
        ("1x1x4", lambda i: cases(i, (1, 1, 4), i["cases"])),
        ("1x2x2", lambda i: cases(i, (1, 2, 2), [k for k in i["cases"] if k[1] == "div"])),
    ])
