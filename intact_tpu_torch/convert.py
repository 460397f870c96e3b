"""Weight bridge: the reference's Pi0 parameter tree (as numpy) -> the port's tensors.

Both packages lay their parameters out the same way (nested dicts, dense
kernels [in, out], per-layer weights stacked [L, ...] under "blocks"), so the
bridge is a checked walk: every reference leaf must land on a port parameter
of the same path and shape, and every port parameter must be filled.
Leftovers on either side raise.
"""

from __future__ import annotations

import numpy as np
import torch

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models.pi0 import model as pi0
from intact_tpu_torch.models.pi0.config import Pi0Config


def _flatten(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def from_jax_params(tree, cfg: Pi0Config, device=None, dtype=torch.float32) -> cm.Params:
    """Map the reference `pi0.init` tree (leaves as numpy arrays) onto the
    port's parameter tree for `cfg`, on `device` (CUDA unless given), in
    `dtype`."""
    device = cm.resolve_device(device)
    template = pi0.init(cfg, device="meta", dtype=dtype)
    src = _flatten(tree)
    want = _flatten(template)
    missing = sorted(set(want) - set(src))
    extra = sorted(set(src) - set(want))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, unconsumed {extra}")

    def fill(node, prefix=""):
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}/{k}" if prefix else k) for k, v in node.items()}
        leaf = np.asarray(src[prefix])
        if tuple(leaf.shape) != tuple(node.shape):
            raise ValueError(f"{prefix}: reference shape {leaf.shape} != port shape {tuple(node.shape)}")
        return torch.from_numpy(np.array(leaf, np.float32)).to(device=device, dtype=dtype)

    return fill(template)
