"""The ranks' mesh (intact_tpu/parallel/mesh.py), one process per card.

Axes, as in the JAX package:
  data    data parallelism: replicas average their gradients
  fsdp    data parallelism with the state split over the ranks: the standard
          step's parameters, gradients and optimizer state by the rules
          (ZeRO-3, parallel/sharding.py, train/optim.py); the fused step's
          optimizer state in global block rows, the whole parameters gathered
          after each update (ZeRO-2, train/fused_joint.py)
  tensor  tensor parallelism: not ported (make_mesh refuses tensor > 1)

`MeshConfig.resolve(n)` takes the world size: the port runs one process per
card, where the JAX package runs one process over all local devices. Rank r
sits at (d, f, t) with r = (d * fsdp + f) * tensor + t. `make_mesh` returns a
`Mesh` holding the rank's coordinates and its process groups: the ranks that
share its fsdp coordinate (its data group), those that share its data
coordinate (its fsdp group), and the world. Without a process group (one
process, nothing initialized) the groups are None and the collectives of
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
    groups: dict  # "data", "fsdp", "world" -> ProcessGroup, or None without a process group

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
    def distributed(self) -> bool:
        """True when the ranks talk through a process group (even a world of one)."""
        return self.groups["world"] is not None


def refuse_tensor(cfg: MeshConfig) -> None:
    if cfg.tensor != 1:
        raise NotImplementedError(
            f"the tensor axis (mesh.tensor={cfg.tensor}) is not ported: the port shards over data and fsdp only "
            "(Megatron-style tensor parallelism needs its K/V head split worked out at one KV head)")


def single_rank_mesh() -> Mesh:
    return Mesh(1, 1, 1, 0, {"data": None, "fsdp": None, "world": None})


_GROUPS: dict = {}  # (the world group, data, fsdp) -> this rank's groups, made once per process group


def make_mesh(cfg: MeshConfig | None = None) -> Mesh:
    """The mesh of the current process group (parallel.distributed.initialize
    first), or of one rank without a group. Every rank must call it, in the
    same order as its other group creations: the first call for a shape
    creates the data and fsdp groups of every rank (each a communicator on
    NCCL); later calls reuse them."""
    import torch.distributed as dist

    cfg = cfg or MeshConfig()
    refuse_tensor(cfg)
    if not (dist.is_available() and dist.is_initialized()):
        cfg.resolve(1)  # raises as the JAX package does on one device
        return single_rank_mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    data, fsdp, _ = cfg.resolve(world)
    key = (dist.group.WORLD, data, fsdp)
    if key not in _GROUPS:
        groups = {"world": dist.group.WORLD}
        for f in range(fsdp):  # the ranks of one fsdp coordinate, over the data axis
            g = dist.new_group([d * fsdp + f for d in range(data)])
            if rank % fsdp == f:
                groups["data"] = g
        for d in range(data):  # the ranks of one data coordinate, over the fsdp axis
            g = dist.new_group([d * fsdp + f for f in range(fsdp)])
            if rank // fsdp == d:
                groups["fsdp"] = g
        _GROUPS[key] = groups
    return Mesh(data, fsdp, 1, rank, dict(_GROUPS[key]))
