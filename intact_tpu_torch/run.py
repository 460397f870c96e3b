"""CLI entry of the train role (intact_tpu/run.py's train dispatch).

    python -m intact_tpu_torch.run --config_path config/train/pi0_finetune_bridge_1chip.yaml \
        --n_updates 3 --log_freq 1 --tokenizer_path hash [--device cpu]

Any config field is overridable with --dotted.path value. --device picks the
device (CUDA unless given). The server role runs through
`python -m intact_tpu_torch.serve`.
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
    if "eval_cfg" in data:
        raise SystemExit("the server role runs through `python -m intact_tpu_torch.serve`")
    return from_dict(TrainPipelineConfig, data), device


def main(argv: list[str] | None = None) -> int:
    cfg, device = build_config(argv if argv is not None else sys.argv[1:])
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    from intact_tpu_torch.train.trainer import Trainer

    Trainer(cfg, device=device).train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
