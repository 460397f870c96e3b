"""The ranks' mesh (intact_tpu/parallel/mesh.py), one process per card.

Axes, as in the JAX package:
  data    data parallelism: replicas average their gradients
  fsdp    data parallelism with the state split over the ranks: the standard
          step's parameters, gradients and optimizer state by the rules
          (ZeRO-3, parallel/sharding.py, train/optim.py); the fused step's
          optimizer state in global block rows, the whole parameters gathered
          after each update (ZeRO-2, train/fused_joint.py)
  tensor  Megatron-style tensor parallelism (serving Pi0, Pi0FAST, native
          SpatialVLA and native Magma; Pi0's standard step): column-parallel
          q, k, v (where their heads split), gate, up, fc1 and Magma's
          lm_head, row-parallel o, down and fc2, the embeddings split over
          their vocabulary, the greedy argmax reduced over tensor
          (models/common.py, parallel/tensor.py); every other path refuses
          tensor > 1 (`refuse_tensor`)

`MeshConfig.resolve(n)` takes the world size: the port runs one process per
card, where the JAX package runs one process over all local devices. Rank r
sits at (d, f, t) with r = (d * fsdp + f) * tensor + t: tensor is the
fastest axis, as in the JAX package. `make_mesh` returns a `Mesh` holding the
rank's coordinates and its process groups, each the ranks that share the
coordinates the axis does not move:
  data    the ranks of its (f, t), over the data axis
  fsdp    the ranks of its (d, t), over the fsdp axis
  tensor  the ranks of its (d, f): its batch coordinate, over the tensor axis
  batch   the ranks of its t, over data x fsdp (a tensor slice's replicas)
  model   the ranks of its d, over fsdp x tensor (one model's parts)
  world   every rank.
At tensor 1 the batch group is the world and the model group the fsdp group
(no communicator is made for them). A batch is split over data x fsdp and
replicated over tensor: the ranks of one batch coordinate d * fsdp + f take
the same rows (`Mesh.batch_index`). Without a process group (one process,
nothing initialized) the groups are None and the collectives of
`parallel/collectives.py` are never called.
"""

from __future__ import annotations

import dataclasses

AXIS_NAMES = ("data", "fsdp", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: absorb remaining devices
    fsdp: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        fixed = self.fsdp * self.tensor
        data = self.data
        if data == -1:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fsdp*tensor={fixed}"
                )
            data = n_devices // fixed
        if data * fixed != n_devices:
            raise ValueError(
                f"mesh {data}x{self.fsdp}x{self.tensor} != {n_devices} devices"
            )
        return data, self.fsdp, self.tensor


def default_mesh_for(n_devices: int) -> MeshConfig:
    """Heuristic: fsdp-major, tensor=1 (the JAX package's)."""
    if n_devices <= 1:
        return MeshConfig(data=1, fsdp=1, tensor=1)
    fsdp = min(n_devices, 8)
    while n_devices % fsdp:
        fsdp //= 2
    return MeshConfig(data=n_devices // fsdp, fsdp=fsdp, tensor=1)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, fsdp, tensor) mesh and its groups."""

    data: int
    fsdp: int
    tensor: int
    rank: int
    groups: dict  # "data", "fsdp", "tensor", "batch", "model", "world" -> ProcessGroup, or None without a group

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXIS_NAMES, (self.data, self.fsdp, self.tensor)))

    @property
    def size(self) -> int:
        return self.data * self.fsdp * self.tensor

    @property
    def fsdp_index(self) -> int:
        return self.rank // self.tensor % self.fsdp

    @property
    def tensor_index(self) -> int:
        return self.rank % self.tensor

    @property
    def batch_index(self) -> int:
        """The rank's batch coordinate d * fsdp + f: the rows it takes."""
        return self.rank // self.tensor

    @property
    def batch_size(self) -> int:
        """The batch coordinates, data x fsdp: the ranks' distinct rows."""
        return self.data * self.fsdp

    @property
    def distributed(self) -> bool:
        """True when the ranks talk through a process group (even a world of one)."""
        return self.groups["world"] is not None


TENSOR_FAMILIES = ("pi0",)  # the model modules whose training step runs at tensor > 1
# the model modules whose serving runs at tensor > 1: Pi0 and the token-decoding families (their
# logits split over the vocabulary, the greedy argmax reduced over tensor: parallel/tensor.py)
TENSOR_SERVING_FAMILIES = ("pi0", "pi0fast", "spatialvla", "magma")
_SLICE = ("the tensor-parallel slice covers serving Pi0, Pi0FAST, native SpatialVLA and native Magma and Pi0's "
          "standard training step")


def refuse_tensor(cfg: MeshConfig, family: str | None = None, fused: bool = False, serving: bool = False) -> None:
    """Raise unless the mesh's tensor axis is 1 or the path runs it: serving
    (`serving`) a family of TENSOR_SERVING_FAMILIES (`family`, the model
    module's package name), or Pi0's standard training step. The fused step,
    every other family's training (Pi0FAST's vocabulary-parallel cross
    entropy is not ported) and every other family's serving (MVLA, mmmvla,
    Octo, the HF-scaffold types) refuse it."""
    if cfg.tensor == 1:
        return
    if fused:
        raise NotImplementedError(
            f"the tensor axis (mesh.tensor={cfg.tensor}) is not ported for the fused step: {_SLICE}; "
            "train the fused recipe at tensor 1")
    if family not in (TENSOR_SERVING_FAMILIES if serving else TENSOR_FAMILIES):
        what = f"serving {family or 'this model'}" if serving else f"training {family or 'this model'}"
        raise NotImplementedError(
            f"the tensor axis (mesh.tensor={cfg.tensor}) is not ported for {what}: {_SLICE}; run it at tensor 1")


def single_rank_mesh() -> Mesh:
    return Mesh(1, 1, 1, 0, {k: None for k in ("data", "fsdp", "tensor", "batch", "model", "world")})


_GROUPS: dict = {}  # (the world group, data, fsdp, tensor) -> this rank's groups, made once per process group


def make_mesh(cfg: MeshConfig | None = None) -> Mesh:
    """The mesh of the current process group (parallel.distributed.initialize
    first), or of one rank without a group. Every rank must call it, in the
    same order as its other group creations: the first call for a shape
    creates the data and fsdp groups of every rank (each a communicator on
    NCCL); later calls reuse them."""
    import torch.distributed as dist

    cfg = cfg or MeshConfig()
    if not (dist.is_available() and dist.is_initialized()):
        cfg.resolve(1)  # raises as the JAX package does on one device
        return single_rank_mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    data, fsdp, tensor = cfg.resolve(world)
    key = (dist.group.WORLD, data, fsdp, tensor)
    if key not in _GROUPS:
        def r(d, f, t):
            return (d * fsdp + f) * tensor + t

        mine = (rank // (fsdp * tensor), rank // tensor % fsdp, rank % tensor)
        axes = {  # group name -> (the coordinates it fixes, its members for those coordinates)
            "data": (lambda d, f, t: (f, t), lambda f, t: [r(d, f, t) for d in range(data)]),
            "fsdp": (lambda d, f, t: (d, t), lambda d, t: [r(d, f, t) for f in range(fsdp)]),
        }
        if tensor > 1:
            axes.update({
                "tensor": (lambda d, f, t: (d, f), lambda d, f: [r(d, f, t) for t in range(tensor)]),
                "batch": (lambda d, f, t: (t,), lambda t: [r(d, f, t) for d in range(data) for f in range(fsdp)]),
                "model": (lambda d, f, t: (d,), lambda d: [r(d, f, t) for f in range(fsdp) for t in range(tensor)]),
            })
        groups = {"world": dist.group.WORLD}
        for name, (fixed, members) in axes.items():
            # every rank creates every group of the axis, in the same order
            keys = sorted({fixed(d, f, t) for d in range(data) for f in range(fsdp) for t in range(tensor)})
            for k in keys:
                g = dist.new_group(members(*k))
                if k == fixed(*mine):
                    groups[name] = g
        if tensor == 1:
            groups.update(tensor=None, batch=dist.group.WORLD, model=groups["fsdp"])
        _GROUPS[key] = groups
    return Mesh(data, fsdp, tensor, rank, dict(_GROUPS[key]))
