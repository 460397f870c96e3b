"""Pipeline configuration: intact_tpu/config/pipeline.py's train and server
roles, copied.

Derivations kept: n_updates = train_episode_count // global_batch_size *
n_epochs; save_model_freq defaults to one epoch of updates; the val data
section inherits unset fields from the train section; with an `eval_cfg`,
the env-adapter and evaluator paths are built from simulator_name, pointing
into intact_tpu_torch.envs.adapters and intact_tpu_torch.envs.evaluators.
Every key the
YAMLs under config/train/ and config/experiment/ set binds here; the trainer
and the server refuse the settings whose paths are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import field
from pathlib import Path

# Bridge dataset statistics (proprio/action mean/std), the hard-coded default
# the reference carries in DataConfig.
BRIDGE_DATASET_STATS: dict = {
    "observation.state": {
        "mean": [0.30904945731163025, 0.03045589290559292, 0.06558273732662201,
                 0.00706630339846015, -0.07828629016876221, 0.10661222040653229,
                 0.7149746417999268],
        "std": [0.06059328466653824, 0.09172434359788895, 0.05185756832361221,
                0.1313914805650711, 0.1698099821805954, 0.573583722114563,
                0.3517141044139862],
        "p01": [0.17017078369855881, -0.16965715914964677, -0.054787094071507454,
                -0.3655692100524902, -0.5435487496852874, -1.3501438736915587,
                0.052190229296684265],
        "p99": [0.4527312242984769, 0.23490807592868757, 0.1973453593254087,
                0.37877989292144754, 0.27723048210143925, 1.8378053522109963,
                1.0105689764022827],
    },
    "action": {
        "mean": [0.00021758403454441577, 0.00012507825158536434,
                 -0.00017109014152083546, -0.0001617111702216789,
                 -0.0002524859446566552, 0.0002515816013328731,
                 0.5879487991333008],
        "std": [0.009632210247218609, 0.013500974513590336, 0.012510341592133045,
                0.028145477175712585, 0.03028254210948944, 0.07585873454809189,
                0.4877150356769562],
        "p01": [-0.028539552688598632, -0.041432044506073, -0.025977383628487588,
                -0.08020886614918708, -0.09213060349225997, -0.2054861941933632,
                0.0],
        "p99": [0.028122276067733765, 0.040630316659808145, 0.03994889184832546,
                0.08121915772557152, 0.07724379181861864, 0.20214049845933896,
                1.0],
    },
}


def _default_data_path() -> Path:
    return Path(os.environ.get("VLA_DATA_DIR", "/tmp/vla_data")) / "resize_224"


@dataclasses.dataclass
class TrainDataConfig:
    dataset_mix: str = "bridge"
    split: str = "train"
    data_path: Path = field(default_factory=_default_data_path)
    window_size: int = 1
    action_horizon: int | None = None  # filled from model chunk_size
    skip_unlabeled: bool = True
    load_proprio: bool = True
    shuffle_buffer_size: int = 200_000
    num_parallel_calls: int = 50
    traj_transform_threads: int = 20
    traj_read_threads: int = 20
    max_action_future: int = 50
    subsample_length: int = 100  # post-chunk frames kept per traj (train)
    image_dropout_prob: float = 0.0  # whole-camera dropout (non-primary)
    # explicit statistics for single-dataset mixes (e.g. the shipped
    # config/dataset/bridge_statistics.json): guarantees training
    # normalizes with the SAME constants serving denormalizes with
    dataset_statistics_path: str | None = None
    # tf.data service dispatcher ("grpc://host:port"): the reference's; the
    # port's RLDS backend refuses it (no TensorFlow)
    service_address: str | None = None


@dataclasses.dataclass
class ValDataConfig:
    dataset_mix: str | None = None
    split: str = "val"
    data_path: Path | None = None
    window_size: int | None = None
    action_horizon: int | None = None
    skip_unlabeled: bool | None = None
    load_proprio: bool | None = None
    shuffle_buffer_size: int = 10_000
    num_parallel_calls: int | None = None
    traj_transform_threads: int | None = None
    traj_read_threads: int | None = None
    max_action_future: int | None = None
    subsample_length: int | None = None
    image_dropout_prob: float | None = None
    dataset_statistics_path: str | None = None


@dataclasses.dataclass
class DataConfig:
    train: TrainDataConfig = field(default_factory=TrainDataConfig)
    val: ValDataConfig = field(default_factory=ValDataConfig)
    dataset_stats: dict = field(default_factory=lambda: dict(BRIDGE_DATASET_STATS))
    train_episode_count: int = 1_550_000
    backend: str = "auto"  # "rlds" | "synthetic" | "auto" (rlds when the section's data_path exists)
    # instruction-paraphrase table (local JSON), for task_paraphrase
    paraphrase_json: str | None = None


@dataclasses.dataclass
class WandBConfig:
    project: str = "INT-ACT"
    entity: str | None = None
    run_id: str | None = None


@dataclasses.dataclass
class EnvConfig:
    dataset_statistics_path: str | None = None
    image_size: tuple[int, int] = (224, 224)
    action_normalization_type: str = "bound"
    state_normalization_type: str = "bound"


@dataclasses.dataclass
class EvalConfig:
    simulator_name: str = "simpler"
    env_adapter: str | None = "BridgeSimplerAdapter"
    task_list: list[str] | None = field(
        default_factory=lambda: [
            "widowx_carrot_on_plate",
            "widowx_put_eggplant_in_basket",
            "widowx_spoon_on_towel",
            "widowx_stack_cube",
        ]
    )
    n_eval_episode: int = 24
    n_video: int = 24
    n_parallel_eval: int | None = None
    recording: bool = True
    pretrained_model_path: str | None = None
    pretrained_model_gradient_step_cnt: list[int] | None = None
    role: str = "server"  # "server" | "client"
    host: str = "0.0.0.0"
    port: int = 8000
    action_step: int = 4
    language_logic_chain: bool = False
    unnorm_key: str | None = None
    # continuous batching: fused device batches pad to power-of-two buckets
    # up to max_batch_size; requests wait at most batch_timeout_ms to fuse
    max_batch_size: int = 64
    batch_timeout_ms: float = 5.0
    prewarm: bool = True  # run every fused-batch bucket once before serving
    # single-card int8 (W8A8) serving of the transformer-block matmuls
    quantize_int8: bool = False
    env_adapter_path: str | None = None
    simulator_path: str | None = None


@dataclasses.dataclass
class MeshSection:
    """Replaces the reference's multi_gpu/mechanism fields
    (`configuration_pipeline.py:159-172`): data/fsdp/tensor axis sizes;
    -1 data absorbs remaining devices."""
    data: int = -1
    fsdp: int = 1
    tensor: int = 1


@dataclasses.dataclass
class TrainPipelineConfig:
    task_paraphrase: bool = False
    data: DataConfig = field(default_factory=DataConfig)

    name: str | None = None
    seed: int = 42
    debug: bool = False

    mesh: MeshSection = field(default_factory=MeshSection)

    use_bf16: bool = True
    remat: bool = False
    optimizer_8bit: bool = False
    # "bfloat16" stores every parameter in bf16 and applies updates with
    # stochastic rounding (the joint recipe's precision)
    master_dtype: str = "float32"
    # fused backward+optimizer (train/fused_joint.py): the pi0 joint recipe
    # with one-step-delayed global-norm clipping; no gradient accumulation.
    # False: the standard step (train/train_step.py)
    fused_update: bool = False
    quantize_frozen_int8: bool = False

    global_batch_size: int = 1024
    per_device_batch_size: int = 32
    n_epochs: int = 15
    max_grad_norm: float = 1.0

    n_updates: int | None = None
    save_model_freq: int | None = None

    log_freq: int = 4
    train_log_metrics: list = field(default_factory=lambda: ["l2_loss"])
    eval_thresholds: list = field(default_factory=lambda: [0.05, 0.1, 0.2, 0.3, 0.5])
    eval_freq: int = 250
    eval_size: int = 1024

    # model config: raw dict from the model JSON (must carry "type")
    model_cfg: dict = field(default_factory=lambda: {"type": "pi0"})
    # language tokenizer asset (a local HF tokenizer directory); "hash" opts
    # into the hermetic fallback explicitly; None defers to
    # $VLA_TOKENIZER_PATH, then the model JSON's "tokenizer_path"
    tokenizer_path: str | None = None
    freeze_lm_head: bool = True
    freeze_vlm: bool = False
    load_from_checkpoint: str | None = None
    resume_run: bool = True

    use_wandb: bool = False
    wandb: WandBConfig = field(default_factory=WandBConfig)

    eval_cfg: EvalConfig | None = None
    env: EnvConfig = field(default_factory=EnvConfig)

    log_dir: Path = field(default_factory=lambda: Path(os.environ.get("VLA_LOG_DIR", "log")))

    def __post_init__(self):
        self.finalize()

    def finalize(self) -> "TrainPipelineConfig":
        self.validate_parallel_eval()
        if self.data.train.action_horizon is None:
            self.data.train.action_horizon = int(self.model_cfg.get("chunk_size", 1))
        for key, value in vars(self.data.train).items():
            if getattr(self.data.val, key, None) is None:
                setattr(self.data.val, key, value)
        if self.n_updates is None:
            self.n_updates = self.data.train_episode_count // self.global_batch_size * self.n_epochs
        if self.save_model_freq is None:
            self.save_model_freq = self.data.train_episode_count // self.global_batch_size
        if self.eval_cfg is not None:
            sim = self.eval_cfg.simulator_name
            if sim is None:
                raise ValueError("Simulator name is not specified in the config.")
            adapter = self.eval_cfg.env_adapter or "BridgeSimplerAdapter"
            self.eval_cfg.env_adapter_path = f"intact_tpu_torch.envs.adapters.{sim}.{adapter}"
            evaluator = sim[:1].upper() + sim[1:] + "Evaluator"
            self.eval_cfg.simulator_path = f"intact_tpu_torch.envs.evaluators.{sim}.{evaluator}"
        return self

    def validate_parallel_eval(self):
        if self.eval_cfg is None:
            return
        npe = self.eval_cfg.n_parallel_eval
        if npe is not None:
            if self.eval_cfg.simulator_name != "simplerMS3":
                raise ValueError("n_parallel_eval is only applicable for simplerMS3")
            if npe <= 1:
                raise ValueError("n_parallel_eval should be greater than 1")
            if self.eval_cfg.env_adapter and "Batch" not in self.eval_cfg.env_adapter:
                raise ValueError(
                    "You need to use an env adapter that supports batch eval for n_parallel_eval>1"
                )
        if npe is None and self.eval_cfg.simulator_name == "simplerMS3":
            raise ValueError("n_parallel_eval should be set for simplerMS3")

    def make_model_config(self):
        """model_cfg dict -> the model config, built as the type's registry
        entry says (`model_json`): from the whole model JSON ("pi0"), its
        default config with the JSON's common fields ("pi0fast", "mvla",
        "mmmvla"), or its default as is (spatialvla_native, magma_native and
        the tiny, CPU-testable types)."""
        from intact_tpu_torch.models import registry

        entry = registry.get(self.model_type)
        if entry["model_json"] is None:
            raise NotImplementedError(f"model type {self.model_type!r} serves the upstream HF model through its "
                                      "wrapper and has no model config here")
        if entry["model_json"] == "json":
            return pi0_config_from_json(self.model_cfg)
        if entry["model_json"] == "common":
            return _replace_common_fields(entry["default_config"](), self.model_cfg)
        return entry["default_config"]()

    @property
    def model_type(self) -> str:
        return self.model_cfg.get("type", "pi0")

    def resolve_tokenizer_path(self) -> str | None:
        return (
            self.tokenizer_path
            or os.environ.get("VLA_TOKENIZER_PATH")
            or self.model_cfg.get("tokenizer_path")
            or None
        )


def _replace_common_fields(base, d: dict):
    """Overlay the model-JSON fields every family shares onto a config."""
    common = [
        "chunk_size", "n_action_steps", "max_state_dim", "max_action_dim",
        "tokenizer_max_length", "num_steps", "num_metaqueries", "n_action_bins",
    ]
    updates = {k: type(getattr(base, k))(d[k]) for k in common if k in d and hasattr(base, k)}
    return dataclasses.replace(base, **updates) if updates else base


def pi0_config_from_json(d: dict):
    """LeRobot-style pi0 JSON (config/models/pi0_finetune_bridge.json) ->
    Pi0Config. Unknown keys are ignored."""
    from intact_tpu_torch.models.pi0.config import Pi0Config

    base = Pi0Config.bridge()
    num_cameras = max(1, len([
        k for k, v in d.get("input_features", {}).items()
        if v.get("type") == "VISUAL"
    ]) + int(d.get("empty_cameras", 0) or 0)) if d.get("input_features") else base.num_cameras

    return dataclasses.replace(
        base,
        chunk_size=int(d.get("chunk_size", base.chunk_size)),
        n_action_steps=int(d.get("n_action_steps", base.n_action_steps)),
        max_state_dim=int(d.get("max_state_dim", base.max_state_dim)),
        max_action_dim=int(d.get("max_action_dim", base.max_action_dim)),
        tokenizer_max_length=int(d.get("tokenizer_max_length", base.tokenizer_max_length)),
        num_steps=int(d.get("num_steps", base.num_steps)),
        num_cameras=num_cameras,
        freeze_vision_encoder=bool(d.get("freeze_vision_encoder", False)),
        train_expert_only=bool(d.get("train_expert_only", False)),
        # every accelerated-attention name maps onto the hand-written kernel
        # path; "xla" opts into the plain path explicitly
        attention_impl={"eager": "pallas", "flex": "pallas", "fa2": "pallas",
                        "pallas": "pallas", "xla": "xla"}.get(
            d.get("attention_implementation", "eager"), "pallas"
        ),
    )


def optimizer_config_from_model_json(d: dict, pipeline: TrainPipelineConfig):
    """Model-JSON optimizer hyperparams -> train.optim.OptimizerConfig.
    grad_accumulation_steps is left at 1: the trainer sets it."""
    from intact_tpu_torch.train.optim import OptimizerConfig

    first_cycle = int(d.get("scheduler_decay_steps", pipeline.n_updates or 30_000))
    warmup = min(int(d.get("scheduler_warmup_steps", 200)), max(first_cycle - 1, 0))
    return OptimizerConfig(
        lr=float(d.get("optimizer_lr", 5e-5)),
        betas=tuple(d.get("optimizer_betas", (0.9, 0.999))),
        eps=float(d.get("optimizer_eps", 1e-8)),
        weight_decay=float(d.get("optimizer_weight_decay", 1e-5)),
        max_grad_norm=pipeline.max_grad_norm,
        warmup_steps=warmup,
        first_cycle_steps=first_cycle,
        min_lr=float(d.get("scheduler_decay_lr", 1e-8)),
        quantize_moments=pipeline.optimizer_8bit,
    )
