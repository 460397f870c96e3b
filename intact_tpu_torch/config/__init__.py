"""Config system: dataclass tree + YAML !include + CLI dot-overrides (the
train and server roles' part of intact_tpu/config, copied)."""

from intact_tpu_torch.config.core import apply_overrides, from_dict, load_yaml, parse_cli, to_dict
from intact_tpu_torch.config.pipeline import (
    DataConfig,
    EnvConfig,
    EvalConfig,
    MeshSection,
    TrainDataConfig,
    TrainPipelineConfig,
    ValDataConfig,
    WandBConfig,
)

__all__ = [
    "apply_overrides", "from_dict", "load_yaml", "parse_cli", "to_dict",
    "DataConfig", "EnvConfig", "EvalConfig", "MeshSection", "TrainDataConfig", "TrainPipelineConfig",
    "ValDataConfig", "WandBConfig",
]
