"""Model registry: type string -> config factory and model module, for the
types the port has (intact_tpu/models/registry.py, cut to them).

A model module exposes init / compute_loss / sample_actions (SpatialVLA
and Magma, serving only: init / predict_action_tokens, init / generate;
Octo's compute_loss takes its diffusion draws as t_int / noise); the policy, the serving
wrapper, the trainer and the weight bridge resolve it from here, and
`make_policy_wrapper` the type's wrapper class (its `wrapper` path). An
entry's `model_json` says how `make_model_config` builds the type's config
from the model JSON: "json" reads the whole config from it, "common" lays its
common fields over the default config, "default" takes the default as is,
None: the type has no config here (the HF-scaffold types).
"""

from __future__ import annotations

import importlib

_REGISTRY: dict[str, dict] = {}


def register(name: str, **entries) -> None:
    _REGISTRY[name] = entries


def get(name: str) -> dict:
    if name not in _REGISTRY:
        raise NotImplementedError(f"model type {name!r} is not a model type (types: {available()})")
    return _REGISTRY[name]


def available() -> list[str]:
    return sorted(_REGISTRY)


def module(name: str):
    """The model module of a registered type."""
    return importlib.import_module(get(name)["module"])


def family(name: str) -> str:
    """A type's family: its model module's package ("pi0", "pi0fast", "mvla",
    "spatialvla", "magma", "octo"), or the type itself without a module."""
    module_name = get(name).get("module")
    return module_name.rsplit(".", 2)[-2] if module_name else name


# model modules without a type (no wrapper, no pipeline config, as in the
# reference), whose trees the weight bridge maps all the same
_UNREGISTERED = ("intact_tpu_torch.models.t5:T5Config", "intact_tpu_torch.models.dreamvla:DreamVLAConfig")


def module_for_config(cfg):
    """The model module whose config class `cfg` is."""
    for entry in _REGISTRY.values():
        if "config_cls" in entry and isinstance(cfg, entry["config_cls"]):
            return importlib.import_module(entry["module"])
    for spec in _UNREGISTERED:
        mod_name, cls_name = spec.split(":")
        mod = importlib.import_module(mod_name)
        if isinstance(cfg, getattr(mod, cls_name)):
            return mod
    raise NotImplementedError(f"no ported model takes a {type(cfg).__name__}")


def _register_builtin() -> None:
    import dataclasses

    from intact_tpu_torch.models.magma.config import MagmaConfig
    from intact_tpu_torch.models.mvla.config import MVLAConfig
    from intact_tpu_torch.models.octo import upstream as octo_upstream
    from intact_tpu_torch.models.octo.config import OctoConfig
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.models.pi0fast.config import Pi0FASTConfig
    from intact_tpu_torch.models.spatialvla.config import SpatialVLAConfig

    wrapper = "intact_tpu_torch.serve.policy_wrapper.Pi0PolicyWrapper"  # the Pi0-shaped families, as in the reference
    mvla = "intact_tpu_torch.models.mvla.model"
    for name, cls, factory, model_json, mod in (
        ("pi0", Pi0Config, Pi0Config.bridge, "json", "intact_tpu_torch.models.pi0.model"),
        ("pi0_tiny", Pi0Config, Pi0Config.tiny, "default", "intact_tpu_torch.models.pi0.model"),
        ("pi0fast", Pi0FASTConfig, Pi0FASTConfig.bridge, "common", "intact_tpu_torch.models.pi0fast.model"),
        ("pi0fast_tiny", Pi0FASTConfig, Pi0FASTConfig.tiny, "default", "intact_tpu_torch.models.pi0fast.model"),
        ("mvla", MVLAConfig, MVLAConfig, "common", mvla),
        ("mvla_tiny", MVLAConfig, MVLAConfig.tiny, "default", mvla),
        ("mmmvla", MVLAConfig, lambda: dataclasses.replace(MVLAConfig(), alternate_pattern="joint"), "common", mvla),
        ("mmmvla_tiny", MVLAConfig, lambda: dataclasses.replace(MVLAConfig.tiny(), alternate_pattern="joint"),
         "default", mvla),
    ):
        register(name, config_cls=cls, default_config=factory, model_json=model_json, module=mod, wrapper=wrapper)
    # native SpatialVLA-4B (SigLIP + Ego3D + Gemma2, HF-checkpoint import)
    for name, factory in (("spatialvla_native", SpatialVLAConfig.spatialvla_4b),
                          ("spatialvla_native_tiny", SpatialVLAConfig.tiny)):
        register(name, config_cls=SpatialVLAConfig, default_config=factory, model_json="default",
                 module="intact_tpu_torch.models.spatialvla.model",
                 wrapper="intact_tpu_torch.serve.policy_wrapper.SpatialVLANativePolicyWrapper")
    # the HF-scaffold wrappers: the upstream transformers models (trust_remote_code, a local snapshot
    # required); no model config or module of the port, as the reference registers none
    for name, wrapper_cls in (("spatialvla", "SpatialVLAPolicyWrapper"), ("magma", "MagmaPolicyWrapper")):
        register(name, model_json=None, wrapper=f"intact_tpu_torch.serve.policy_wrapper.{wrapper_cls}")
    # native Magma-8B (ConvNeXt + LLaMA-3, HF-checkpoint import)
    for name, factory in (("magma_native", MagmaConfig.magma_8b), ("magma_native_tiny", MagmaConfig.tiny)):
        register(name, config_cls=MagmaConfig, default_config=factory, model_json="default",
                 module="intact_tpu_torch.models.magma.model",
                 wrapper="intact_tpu_torch.serve.policy_wrapper.MagmaNativePolicyWrapper")
    # Octo: the native model and the released architecture (T5-base, checkpoint import)
    for name, cls, factory, mod in (
        ("octo", OctoConfig, OctoConfig.small, "intact_tpu_torch.models.octo.model"),
        ("octo_tiny", OctoConfig, OctoConfig.tiny, "intact_tpu_torch.models.octo.model"),
        ("octo_small_upstream", octo_upstream.OctoUpstreamConfig, octo_upstream.octo_small,
         "intact_tpu_torch.models.octo.upstream"),
        ("octo_base_upstream", octo_upstream.OctoUpstreamConfig, octo_upstream.octo_base,
         "intact_tpu_torch.models.octo.upstream"),
    ):
        register(name, config_cls=cls, default_config=factory, model_json="default", module=mod,
                 wrapper="intact_tpu_torch.serve.policy_wrapper.OctoPolicyWrapper")


_register_builtin()
