"""CLI entry: config parse + role dispatch (intact_tpu/run.py's train, server and client roles).

    python -m intact_tpu_torch.run --config_path config/train/pi0_finetune_bridge_1chip.yaml \
        --n_updates 3 --log_freq 1 --tokenizer_path hash [--device cpu]
    python -m intact_tpu_torch.run --config_path config/train/pi0_finetune_bridge_expertonly.yaml \
        --mesh.fsdp 1 --global_batch_size 192 --n_updates 3 --tokenizer_path hash [--device cpu]
    torchrun --standalone --nproc_per_node 4 -m intact_tpu_torch.run \
        --config_path config/train/pi0_finetune_bridge.yaml --tokenizer_path hash [--device cpu]
    python -m intact_tpu_torch.run --config_path config/experiment/simpler/pi0_finetune_bridge_ev.yaml \
        --eval_cfg.role server --eval_cfg.quantize_int8 true [--eval_cfg.pretrained_model_path null] \
        [--tokenizer_path hash] [--device cpu]
    torchrun --standalone --nproc_per_node N -m intact_tpu_torch.run \
        --config_path config/experiment/simpler/pi0_finetune_bridge_ev.yaml \
        --eval_cfg.role server [--mesh.fsdp F] [--mesh.tensor T] [--device cpu]
    python -m intact_tpu_torch.run --config_path config/experiment/simpler/pi0_finetune_bridge_ev.yaml \
        --eval_cfg.role client [--eval_cfg.host HOST --eval_cfg.port PORT]

Any config field is overridable with --dotted.path value. --device picks the
device of the train and server roles (CUDA unless given). Under torchrun the
train role runs one rank per process: NCCL over the cards (cuda:LOCAL_RANK),
or gloo with --device cpu; the yaml's mesh (data -1 x fsdp 4 in the
multi-card recipes) must fill the world size. Without `eval_cfg`
the config trains; with it, `eval_cfg.role` server serves the configured
policy over the websocket protocol (under torchrun every rank holds its
share of the parameters, rank 0 serves and the others run their rows of
each fused batch, serve/group.py; the mesh must fill the world; at
mesh.tensor > 1, Pi0, MVLA, Pi0FAST, native SpatialVLA and native Magma, the
tensor ranks of a batch coordinate run their slices of the model on the same
rows; Octo runs whole on rank 0), and client runs the simulator evaluator
that `eval_cfg.simulator_path` names (built from simulator_name) against such
a server; it touches no device, and its simulator (SimplerEnv, ManiSkill3 or
LIBERO) must be installed.
"""

from __future__ import annotations

import logging
import sys

from intact_tpu_torch.config import TrainPipelineConfig, apply_overrides, from_dict, load_yaml, parse_cli


def build_config(argv: list[str]) -> tuple[TrainPipelineConfig, str | None]:
    """argv -> (config, device)."""
    config_path, overrides = parse_cli(argv)
    device = overrides.pop("device", None)
    data = load_yaml(config_path) if config_path else {}
    if overrides:
        data = apply_overrides(data, overrides)
    return from_dict(TrainPipelineConfig, data), device


def serve_on_ranks(cfg: TrainPipelineConfig, device) -> None:
    """The server role on this rank's device: without a process group the
    wrapper serves as on one card; in a group every rank builds the wrapper
    on its share of the parameters, rank 0 serves and sends "stop" when its
    server ends, and the others follow it (serve/group.py)."""
    from intact_tpu_torch.models import registry
    from intact_tpu_torch.parallel import MeshConfig, make_mesh
    from intact_tpu_torch.parallel.mesh import refuse_tensor
    from intact_tpu_torch.serve.group import ServeGroup
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper, wrapper_class
    from intact_tpu_torch.serve.server import serve

    log = logging.getLogger("run")
    mesh_cfg = MeshConfig(cfg.mesh.data, cfg.mesh.fsdp, cfg.mesh.tensor)
    refuse_tensor(mesh_cfg, registry.family(cfg.model_type), serving=True)
    mesh = make_mesh(mesh_cfg)
    if not mesh.distributed:
        policy = make_policy_wrapper(cfg, device=device)
    elif wrapper_class(cfg).serves_on_ranks:
        policy = make_policy_wrapper(cfg, device=device, mesh=mesh)
        log.info("rank %d of %d: mesh %s, its share of %s", mesh.rank, mesh.size, mesh.shape, cfg.model_type)
    else:
        log.info("%s runs whole on rank 0; ranks 1..%d wait for its stop", cfg.model_type, mesh.size - 1)
        policy = make_policy_wrapper(cfg, device=device) if mesh.rank == 0 else None
    group = getattr(policy, "group", None) or (ServeGroup(mesh, device) if mesh.distributed else None)
    if mesh.rank != 0:
        group.follow()
        return
    log.info("serving %s on %s:%d", cfg.model_type, cfg.eval_cfg.host, cfg.eval_cfg.port)
    try:
        serve(policy, cfg)
    finally:
        if group is not None:
            group.stop()


def main(argv: list[str] | None = None) -> int:
    cfg, device = build_config(argv if argv is not None else sys.argv[1:])
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    if cfg.eval_cfg is None:
        from intact_tpu_torch.parallel import distributed
        from intact_tpu_torch.train.trainer import Trainer

        try:
            Trainer(cfg, device=device).train()
        finally:
            distributed.destroy()
        return 0

    if cfg.eval_cfg.role == "server":
        from intact_tpu_torch.parallel import distributed

        try:
            serve_on_ranks(cfg, distributed.initialize(device))
        finally:
            distributed.destroy()
        return 0

    if cfg.eval_cfg.role == "client":
        from intact_tpu_torch.utils.pipeline import get_class_from_path

        get_class_from_path(cfg.eval_cfg.simulator_path)(cfg).evaluate()
        return 0

    raise ValueError(f"unknown role {cfg.eval_cfg.role!r}")


if __name__ == "__main__":
    sys.exit(main())
