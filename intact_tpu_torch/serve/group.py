"""Serving over several ranks, one process per card: rank 0 serves, the others follow.

The JAX package serves on every device of its host from one controller; the
port runs one process per card (torchrun), so the ranks keep step by hand.
Rank 0 runs the websocket and batching server, the sessions and the adapters,
as on one card. At each device call it broadcasts over the world group:

  1. a header: int64[HEADER], the op's index in OPS, the number of arrays, and
     per array its dtype's index in DTYPES, its ndim and its shape;
  2. the arrays (as bytes), already tokenized and padded on rank 0.

A row op ("sample", "predict", "generate"; the serving wrapper pads its
batch to a multiple of data x fsdp, the batch coordinates) then runs its
handler on every rank over its coordinate's rows [c * b / n, (c + 1) * b / n)
of each array (c = d * fsdp + f: the tensor ranks of one coordinate take the
same rows and run their tensor slices of the model together), and the ranks'
outputs are all-gathered in rank order, each coordinate's taken from its
tensor rank 0 (rank 0 slices the padding off). A whole op ("switch") runs its handler on the whole arrays on every
rank. "stop", which rank 0 sends when its server ends, ends the followers'
loop. Every broadcast and gather goes through parallel/collectives.py and is
counted there. Nothing catches a follower's exception: the rank exits
non-zero and the launcher brings the group down.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from intact_tpu_torch.parallel import collectives
from intact_tpu_torch.parallel.sharding import all_gather_bytes, local_rows

log = logging.getLogger("intact_tpu_torch.serve.group")

OPS = ("stop", "sample", "predict", "generate", "switch")
DTYPES = (torch.uint8, torch.bool, torch.int32, torch.int64, torch.float32, torch.bfloat16, torch.float16)
HEADER = 64
MAX_NDIM = 6


def to_device(x, device) -> torch.Tensor:
    """A host array (a writable copy) or a tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


class ServeGroup:
    """This rank's side of the serving protocol over the mesh's world group.
    `on(op, fn, rows)` registers a handler, the same on every rank."""

    def __init__(self, mesh, device):
        if not mesh.distributed:
            raise ValueError("a serving group needs a process group (parallel.distributed.initialize)")
        self.mesh = mesh
        self.rank, self.world = mesh.rank, mesh.size
        self.rows = mesh.batch_size  # the batch coordinates a row op's batch is split over
        self.device = torch.device(device)  # where the arrays arrive: the card on NCCL, the CPU on gloo
        self._group = mesh.groups["world"]
        self._handlers: dict = {}
        self._stopped = False

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def on(self, op: str, fn, rows: bool = True) -> None:
        if op not in OPS or op == "stop":
            raise ValueError(f"unknown serving op {op!r}")
        self._handlers[op] = (fn, rows)

    # -- rank 0 ---------------------------------------------------------------

    def call(self, op: str, arrays) -> torch.Tensor | None:
        """Rank 0: run `op` on every rank over `arrays` (host arrays or
        tensors; for a row op each holds the same number of rows, a multiple
        of the world size) -> the gathered output of a row op, else None."""
        if not self.leader or self._stopped:
            raise RuntimeError(f"rank {self.rank} cannot start a serving call (stopped: {self._stopped})")
        tensors = [to_device(a, self.device).contiguous() for a in arrays]
        self._send_header(op, tensors)
        for t in tensors:
            collectives.broadcast(t.view(-1).view(torch.uint8), self._group)
        return self._run(op, tensors)

    def stop(self) -> None:
        """Rank 0: end the followers' loop (once)."""
        if self.leader and not self._stopped:
            self._send_header("stop", [])
            self._stopped = True
            log.info("serving group: stop sent to %d follower(s)", self.world - 1)

    # -- the other ranks ----------------------------------------------------------

    def follow(self) -> None:
        """Ranks 1..w-1: run what rank 0 asks, call by call, until "stop"."""
        if self.leader:
            raise RuntimeError("rank 0 serves; it does not follow")
        log.info("serving group: rank %d of %d follows rank 0", self.rank, self.world)
        calls = 0
        while True:
            op, specs = self._receive_header()
            if op == "stop":
                log.info("serving group: rank %d stops after %d call(s)", self.rank, calls)
                return
            tensors = []
            for dtype, shape in specs:
                buf = torch.empty(int(np.prod(shape, dtype=np.int64)) * dtype.itemsize, dtype=torch.uint8,
                                  device=self.device)
                collectives.broadcast(buf, self._group)
                tensors.append(buf.view(dtype).view(shape))
            self._run(op, tensors)
            calls += 1

    # -- both ---------------------------------------------------------------------

    def _run(self, op: str, tensors: list) -> torch.Tensor | None:
        fn, rows = self._handlers[op]
        if not rows:
            fn(*tensors)
            return None
        out = fn(*(local_rows(t, self.mesh.batch_index, self.rows) for t in tensors)).contiguous()
        gathered = all_gather_bytes(out, self._group, self.world)[::self.mesh.tensor]  # each coordinate's tensor rank 0
        return gathered.reshape(-1, *out.shape[1:])

    def _send_header(self, op: str, tensors: list) -> None:
        head = [OPS.index(op), len(tensors)]
        for t in tensors:
            if t.ndim > MAX_NDIM or t.dtype not in DTYPES:
                raise ValueError(f"cannot send a {t.dtype} array of shape {tuple(t.shape)} to the ranks")
            head += [DTYPES.index(t.dtype), t.ndim, *t.shape, *[0] * (MAX_NDIM - t.ndim)]
        if len(head) > HEADER:
            raise ValueError(f"{len(tensors)} arrays do not fit the {HEADER}-entry header")
        header = torch.zeros(HEADER, dtype=torch.int64, device=self.device)
        header[:len(head)] = torch.tensor(head, dtype=torch.int64)
        collectives.broadcast(header, self._group)

    def _receive_header(self) -> tuple[str, list]:
        header = torch.empty(HEADER, dtype=torch.int64, device=self.device)
        collectives.broadcast(header, self._group)
        head = header.tolist()
        specs, at = [], 2
        for _ in range(head[1]):
            code, ndim = head[at], head[at + 1]
            specs.append((DTYPES[code], tuple(head[at + 2:at + 2 + ndim])))
            at += 2 + MAX_NDIM
        return OPS[head[0]], specs


def path_array(path: str) -> np.ndarray:
    """A checkpoint path as bytes, for a "switch" call."""
    return np.frombuffer(str(path).encode(), dtype=np.uint8).copy()


def path_of(t: torch.Tensor) -> str:
    return bytes(t.cpu().numpy().tobytes()).decode()
