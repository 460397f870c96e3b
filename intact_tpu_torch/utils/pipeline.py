"""Seeding and dynamic class loading (the parts of intact_tpu/utils/pipeline.py
the serving stack and the evaluators use)."""

from __future__ import annotations

import importlib
import os
import random

import numpy as np
import torch


def set_seed_everywhere(seed: int, train: bool = True) -> None:
    """Seed Python, numpy and torch (CPU and every CUDA device).

    `train` is the reference's signature: there it also seeds TensorFlow's
    data pipeline, which the port does not have, so here it has no effect."""
    np.random.seed(seed)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)


def get_class_from_path(class_path: str):
    """Resolve "pkg.module.ClassName" -> class object (the config layer's hook
    for env adapters and evaluators)."""
    module_name, class_name = class_path.rsplit(".", 1)
    module = importlib.import_module(module_name)
    return getattr(module, class_name)
