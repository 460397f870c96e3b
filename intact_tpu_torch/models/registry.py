"""Model registry: type string -> config factory and model module, for the
types the port has (intact_tpu/models/registry.py, cut to them).

A model module exposes init / compute_loss / sample_actions; the policy, the
serving wrapper, the trainer and the weight bridge resolve it from here, and
`make_policy_wrapper` the type's wrapper class (its `wrapper` path).
"""

from __future__ import annotations

import importlib

_REGISTRY: dict[str, dict] = {}


def register(name: str, **entries) -> None:
    _REGISTRY[name] = entries


def get(name: str) -> dict:
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"model type {name!r} is not ported (ported: {available()}); the other families are the "
            "ROADMAP item 'the other model families and their wrappers'")
    return _REGISTRY[name]


def available() -> list[str]:
    return sorted(_REGISTRY)


def module(name: str):
    """The model module of a registered type."""
    return importlib.import_module(get(name)["module"])


def module_for_config(cfg):
    """The model module whose config class `cfg` is."""
    for entry in _REGISTRY.values():
        if isinstance(cfg, entry["config_cls"]):
            return importlib.import_module(entry["module"])
    raise NotImplementedError(f"no ported model takes a {type(cfg).__name__}")


def _register_builtin() -> None:
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.models.pi0fast.config import Pi0FASTConfig

    wrapper = "intact_tpu_torch.serve.policy_wrapper.Pi0PolicyWrapper"  # both families, as in the reference
    for name, cls, factory, mod in (
        ("pi0", Pi0Config, Pi0Config.bridge, "intact_tpu_torch.models.pi0.model"),
        ("pi0_tiny", Pi0Config, Pi0Config.tiny, "intact_tpu_torch.models.pi0.model"),
        ("pi0fast", Pi0FASTConfig, Pi0FASTConfig.bridge, "intact_tpu_torch.models.pi0fast.model"),
        ("pi0fast_tiny", Pi0FASTConfig, Pi0FASTConfig.tiny, "intact_tpu_torch.models.pi0fast.model"),
    ):
        register(name, config_cls=cls, default_config=factory, module=mod, wrapper=wrapper)


_register_builtin()
