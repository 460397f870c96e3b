"""CLI entry: config parse + role dispatch (intact_tpu/run.py's train and server roles).

    python -m intact_tpu_torch.run --config_path config/train/pi0_finetune_bridge_1chip.yaml \
        --n_updates 3 --log_freq 1 --tokenizer_path hash [--device cpu]
    python -m intact_tpu_torch.run --config_path config/train/pi0_finetune_bridge_expertonly.yaml \
        --mesh.fsdp 1 --global_batch_size 192 --n_updates 3 --tokenizer_path hash [--device cpu]
    python -m intact_tpu_torch.run --config_path config/experiment/simpler/pi0_finetune_bridge_ev.yaml \
        --eval_cfg.role server --eval_cfg.quantize_int8 true [--eval_cfg.pretrained_model_path null] \
        [--tokenizer_path hash] [--device cpu]

Any config field is overridable with --dotted.path value. --device picks the
device (CUDA unless given). Without `eval_cfg` the config trains; with it,
`eval_cfg.role` server serves the configured policy over the websocket
protocol. The client role drives the simulator evaluators, which are not
ported yet (ROADMAP: the client role and the simulator evaluators) and raises.
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
        from intact_tpu_torch.train.trainer import Trainer

        Trainer(cfg, device=device).train()
        return 0

    if cfg.eval_cfg.role == "server":
        from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper
        from intact_tpu_torch.serve.server import serve

        policy = make_policy_wrapper(cfg, device=device)
        logging.getLogger("run").info("serving %s on %s:%d", cfg.model_type, cfg.eval_cfg.host, cfg.eval_cfg.port)
        serve(policy, cfg)
        return 0

    if cfg.eval_cfg.role == "client":
        raise NotImplementedError(
            "the client role (simulator evaluators) is not ported yet; see the ROADMAP item 'the client role and "
            "the simulator evaluators'")

    raise ValueError(f"unknown role {cfg.eval_cfg.role!r}")


if __name__ == "__main__":
    sys.exit(main())
