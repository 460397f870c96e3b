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
    python -m intact_tpu_torch.run --config_path config/experiment/simpler/pi0_finetune_bridge_ev.yaml \
        --eval_cfg.role client [--eval_cfg.host HOST --eval_cfg.port PORT]

Any config field is overridable with --dotted.path value. --device picks the
device of the train and server roles (CUDA unless given). Under torchrun the
train role runs one rank per process: NCCL over the cards (cuda:LOCAL_RANK),
or gloo with --device cpu; the yaml's mesh (data -1 x fsdp 4 in the
multi-card recipes) must fill the world size. Without `eval_cfg`
the config trains; with it, `eval_cfg.role` server serves the configured
policy over the websocket protocol, and client runs the simulator evaluator
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
        from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper
        from intact_tpu_torch.serve.server import serve

        policy = make_policy_wrapper(cfg, device=device)
        logging.getLogger("run").info("serving %s on %s:%d", cfg.model_type, cfg.eval_cfg.host, cfg.eval_cfg.port)
        serve(policy, cfg)
        return 0

    if cfg.eval_cfg.role == "client":
        from intact_tpu_torch.utils.pipeline import get_class_from_path

        get_class_from_path(cfg.eval_cfg.simulator_path)(cfg).evaluate()
        return 0

    raise ValueError(f"unknown role {cfg.eval_cfg.role!r}")


if __name__ == "__main__":
    sys.exit(main())
