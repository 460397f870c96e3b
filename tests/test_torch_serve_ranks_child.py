"""The rank processes of tests/test_torch_serve_ranks.py, spawned with
torch.multiprocessing into a gloo group on the CPU. This module holds no test
and imports no JAX: a rank runs only the port.

Each entry takes (rank, world, port, workdir): it joins the group through
`parallel.distributed.initialize("cpu")` from torchrun's variables, reads its
inputs from workdir/inputs.pt (written by the test), runs each task (rank 0
drives the serving group, the other ranks follow it until its "stop") and
writes what rank 0 measured, and what every rank held, to
workdir/<group>_rank<r>.pt.
"""

from __future__ import annotations

import asyncio
import os
import threading
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
EV_CONFIG = REPO / "config/experiment/simpler/pi0_finetune_bridge_ev.yaml"
STATS = REPO / "config/dataset/bridge_statistics.json"
WAIT_S = 60.0  # the longest a websocket wait or a client thread's join may take
IMAGE = 28  # Pi0Config.tiny()'s frames, as the env adapter sends them


def _join(rank: int, world: int, port: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    torch.set_num_threads(1)
    from intact_tpu_torch.parallel import distributed

    distributed.initialize("cpu")


def server_config(model_type: str, **overrides):
    """The server role's config of `model_type`, as the run CLI builds it
    from the ev yaml (random weights, hash tokenizer, the CPU)."""
    from intact_tpu_torch import run

    argv = ["--config_path", str(EV_CONFIG), "--eval_cfg.role", "server", "--eval_cfg.pretrained_model_path", "null",
            "--model_cfg.type", model_type, "--tokenizer_path", "hash", "--use_bf16", "false",
            "--env.image_size", f"[{IMAGE}, {IMAGE}]", "--env.dataset_statistics_path", str(STATS),
            "--eval_cfg.env_adapter", "BridgeSimplerAdapter"]
    for k, v in overrides.items():
        argv += [f"--{k}", str(v)]
    return run.build_config(argv)[0]


def mesh_of(data: int, fsdp: int):
    from intact_tpu_torch.parallel import MeshConfig, make_mesh

    return make_mesh(MeshConfig(data=data, fsdp=fsdp))


def fixed_noise(wrapper, noise: torch.Tensor) -> None:
    """Rank 0 draws the padded batch's noise as the first rows of `noise`."""
    wrapper.policy._draw_noise = lambda rows: noise[:rows].clone()


def sharded_leaves(params) -> dict:
    """{path: (the local slice's shape, the whole shape)} of a rank's Sharded leaves."""
    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.parallel.sharding import Sharded

    return {k: (tuple(v.local.shape), tuple(v.shape)) for k, v in flatten_paths(params).items()
            if isinstance(v, Sharded)}


def run_wrapper(wrapper, batches: list[dict]) -> list:
    """Rank 0 samples each batch over the group, then stops it; the others
    follow -> rank 0's actions (None elsewhere)."""
    if wrapper.group.rank != 0:
        wrapper.group.follow()
        return None
    out = [wrapper.sample_action_chunk(b) for b in batches]
    wrapper.group.stop()
    return out


def run_tokens(wrapper, op: str, args) -> np.ndarray | None:
    """Rank 0 decodes `args` through the native wrapper's `op` over the
    group, then stops it; the others follow -> rank 0's ids (None elsewhere)."""
    if wrapper.group.rank != 0:
        wrapper.group.follow()
        return None
    ids = getattr(wrapper, op)(*args)
    wrapper.group.stop()
    return ids


def pi0_wrapper(inputs: dict, mesh, quantize: bool = False, model_type: str = "pi0_tiny"):
    """The server role's wrapper of `model_type` on the CPU over `mesh`;
    pi0_tiny loads the JAX package's weights from their step checkpoint."""
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    over = {"eval_cfg.quantize_int8": str(quantize).lower()}
    if model_type == "pi0_tiny":
        over["eval_cfg.pretrained_model_path"] = inputs["jax_ckpt"]
    return make_policy_wrapper(server_config(model_type, **over), device="cpu", mesh=mesh)


NATIVE = {"spatialvla_native_tiny": "predict_tokens", "magma_native_tiny": "generate_tokens"}


def collective_calls() -> dict:
    from intact_tpu_torch.parallel import collectives

    return {"broadcast": collectives.broadcast.calls, "all_gather": collectives.all_gather.calls,
            "bucket_all_gather": collectives.bucket_all_gather.calls}


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

def pi0_tasks(rank: int, inputs: dict) -> dict:
    """Pi0 fp32 at data 2 and int8 at fsdp 2 on the JAX package's weights;
    Pi0 at data 2 on rank 0's own noise draw; MVLA at fsdp 2 on the seed's."""
    from intact_tpu_torch.parallel import collectives

    out = {}
    for name, (data, fsdp), quantize in (("pi0_2x1", (2, 1), False), ("int8_1x2", (1, 2), True)):
        wrapper = pi0_wrapper(inputs, mesh_of(data, fsdp), quantize)
        fixed_noise(wrapper, inputs["pi0_noise"])
        collectives.reset()
        out[name] = {"actions": run_wrapper(wrapper, [inputs["pi0_batch"]]),
                     "sharded": sharded_leaves(wrapper.policy.params), "collectives": collective_calls()}
    wrapper = pi0_wrapper(inputs, mesh_of(2, 1))  # _draw_noise left in place
    out["pi0_draw"] = {"actions": run_wrapper(wrapper, [inputs["draw_batch"]])}
    wrapper = pi0_wrapper(inputs, mesh_of(1, 2), model_type="mvla_tiny")
    fixed_noise(wrapper, inputs["mvla_noise"])
    out["mvla_1x2"] = {"actions": run_wrapper(wrapper, [inputs["mvla_batch"]]),
                       "sharded": sharded_leaves(wrapper.policy.params)}
    return out


def native_checkpoint_tasks(rank: int, inputs: dict) -> dict:
    """The native SpatialVLA and Magma wrappers (int8) built at fsdp 2 from a
    step checkpoint (eval_cfg.pretrained_model_path): every rank restores
    its own share while it builds; rank 0 decodes over the group."""
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    out = {}
    for name, op in NATIVE.items():
        cfg = server_config(name, **{"eval_cfg.quantize_int8": "true",
                                     "eval_cfg.pretrained_model_path": inputs["native_ckpt"][name]})
        wrapper = make_policy_wrapper(cfg, device="cpu", mesh=mesh_of(1, 2))
        out[name] = {"ids": run_tokens(wrapper, op, inputs[name]), "sharded": sharded_leaves(wrapper.params),
                     "generation": wrapper.model_generation}
    return out


def switch_task(rank: int, inputs: dict) -> dict:
    """The server role's Pi0 wrapper at fsdp 2 switches to a checkpoint: every
    rank restores its own share; rank 0 samples from it."""
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    wrapper = make_policy_wrapper(server_config("pi0_tiny"), device="cpu", mesh=mesh_of(1, 2))
    fixed_noise(wrapper, inputs["pi0_noise"])
    if rank != 0:
        wrapper.group.follow()
        return {"sharded": sharded_leaves(wrapper.policy.params), "generation": wrapper.model_generation}
    wrapper.switch_model(inputs["ckpt"])
    actions = wrapper.sample_action_chunk(inputs["pi0_batch"])
    wrapper.group.stop()
    return {"actions": actions, "sharded": sharded_leaves(wrapper.policy.params), "generation": wrapper.model_generation}


def fake_serve(requests: list, results: dict):
    """A stand-in for serve/server.py's serve: rank 0's wrapper answers
    `requests` (one infer_batch each) and returns, as a server that ends."""
    def serve(policy, config):
        results["type"] = type(policy).__name__
        results["answers"] = [policy.infer_batch([(policy.session.preprocess(obs), policy.session)])[0]
                              for obs in requests]
    return serve


def octo_task(rank: int, inputs: dict) -> dict:
    """Octo at world 2: rank 0 builds and serves it whole; rank 1 builds
    nothing and waits for the stop."""
    from intact_tpu_torch import run
    from intact_tpu_torch.serve import server

    results: dict = {}
    cfg = server_config("octo_tiny", **{"eval_cfg.env_adapter": "OctoBridgeSimplerAdapter",
                                        "env.image_size": "[32, 32]"})
    real = server.serve
    server.serve = fake_serve(inputs["octo_obs"], results)
    try:
        run.serve_on_ranks(cfg, torch.device("cpu"))
    finally:
        server.serve = real
    return results


class Client:
    """The wire protocol's client with every wait bounded."""

    def __init__(self, port: int):
        import websockets.sync.client

        from intact_tpu_torch.protocol import msgpack_numpy

        self._msg = msgpack_numpy
        self._packer = msgpack_numpy.Packer()
        self._ws = websockets.sync.client.connect(f"ws://127.0.0.1:{port}", compression=None, max_size=None,
                                                  open_timeout=WAIT_S, ping_timeout=None)
        self.metadata = msgpack_numpy.unpackb(self._ws.recv(timeout=WAIT_S))

    def send(self, obs):
        self._ws.send(self._packer.pack(obs))
        resp = self._ws.recv(timeout=WAIT_S)
        if isinstance(resp, str):  # the server ships a traceback as text
            raise RuntimeError(resp)
        return self._msg.unpackb(resp)

    def close(self):
        self._ws.close()


def batching_serve(requests: list, results: dict):
    """A stand-in for serve/server.py's serve: the real batching server
    (prewarm on) on an ephemeral loopback port, one client per request in a
    daemon thread (joined within WAIT_S), each sending its observation at
    once so the server fuses them; the server ends once they are answered."""
    def serve(policy, config):
        from intact_tpu_torch.serve.batching import BatchingPolicyServer

        ec = config.eval_cfg
        srv = BatchingPolicyServer(policy, config, host="127.0.0.1", port=0, metadata={"model": config.model_type},
                                   max_batch_size=ec.max_batch_size, batch_timeout_ms=200, prewarm=True)
        answers: dict = {}

        def client(port: int, i: int, start: threading.Barrier) -> None:
            c = Client(port)
            try:
                results.setdefault("metadata", c.metadata)
                start.wait(WAIT_S)
                answers[i] = np.asarray(c.send(requests[i]))
                answers[f"reset{i}"] = c.send({"reset": True})
            finally:
                c.close()

        async def main():
            import websockets.asyncio.server

            srv._queue = asyncio.Queue()
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(srv._device_executor, policy.prewarm)
            worker = asyncio.create_task(srv._batch_worker())
            try:
                async with websockets.asyncio.server.serve(srv._handler, "127.0.0.1", 0, compression=None,
                                                           max_size=None) as ws:
                    port = ws.sockets[0].getsockname()[1]
                    start = threading.Barrier(len(requests))
                    threads = [threading.Thread(target=client, args=(port, i, start), daemon=True)
                               for i in range(len(requests))]
                    for t in threads:
                        t.start()
                    for t in threads:
                        await loop.run_in_executor(None, t.join, WAIT_S)
                    results["clients_alive"] = sum(t.is_alive() for t in threads)
            finally:
                worker.cancel()
                srv._device_executor.shutdown(wait=True)

        asyncio.run(main())
        results["answers"] = [answers.get(i) for i in range(len(requests))]
        results["resets"] = [answers.get(f"reset{i}") for i in range(len(requests))]

    return serve


def server_task(rank: int, inputs: dict) -> dict:
    """run.py's server role at 2 ranks (data 1 x fsdp 2, int8): rank 0's
    batching server answers loopback websocket clients, rank 1 runs its rows
    of every fused batch and stops with the server."""
    from intact_tpu_torch import run
    from intact_tpu_torch.parallel import collectives
    from intact_tpu_torch.serve import server

    results: dict = {}
    cfg = server_config("pi0_tiny", **{"eval_cfg.quantize_int8": "true", "eval_cfg.max_batch_size": 4,
                                       "mesh.fsdp": 2})
    real = server.serve
    server.serve = batching_serve(inputs["server_obs"], results)
    collectives.reset()
    try:
        run.serve_on_ranks(cfg, torch.device("cpu"))
    finally:
        server.serve = real
    results["collectives"] = collective_calls()
    return results


def pair(rank: int, world: int, port: int, workdir: str) -> None:
    _join(rank, world, port)
    from intact_tpu_torch.parallel import distributed

    inputs = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    out = {"pi0": pi0_tasks(rank, inputs), "native": native_checkpoint_tasks(rank, inputs),
           "switch": switch_task(rank, inputs), "octo": octo_task(rank, inputs), "server": server_task(rank, inputs)}
    torch.save(out, Path(workdir) / f"pair_rank{rank}.pt")
    distributed.destroy()


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

def quad(rank: int, world: int, port: int, workdir: str) -> None:
    """Pi0 fp32 on the JAX package's weights at (2, 2, 1), batches 8, 1 and
    3; Pi0FAST fp32 and int8, and int8 SpatialVLA and Magma, at (2, 2, 1),
    their actions or tokens for 3 rows."""
    _join(rank, world, port)
    from intact_tpu_torch.parallel import distributed
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    inputs = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    out = {}
    wrapper = pi0_wrapper(inputs, mesh_of(2, 2))
    fixed_noise(wrapper, inputs["pi0_noise"])
    b = inputs["pi0_batch"]
    batches = [b] + [{k: v[:n] for k, v in b.items()} for n in (1, 3)]
    out["pi0_2x2"] = {"actions": run_wrapper(wrapper, batches), "sharded": sharded_leaves(wrapper.policy.params)}
    for name, quantize in (("pi0fast_tiny", False), ("pi0fast_tiny_int8", True)):
        wrapper = pi0_wrapper(inputs, mesh_of(2, 2), quantize, model_type="pi0fast_tiny")
        out[name] = {"actions": run_wrapper(wrapper, [inputs["pi0fast_batch"]]),
                     "sharded": sharded_leaves(wrapper.policy.params)}
    for name, op in NATIVE.items():
        wrapper = make_policy_wrapper(server_config(name, **{"eval_cfg.quantize_int8": "true"}), device="cpu",
                                      mesh=mesh_of(2, 2))
        out[name] = {"ids": run_tokens(wrapper, op, inputs[name]), "sharded": sharded_leaves(wrapper.params)}
    torch.save(out, Path(workdir) / f"quad_rank{rank}.pt")
    distributed.destroy()
