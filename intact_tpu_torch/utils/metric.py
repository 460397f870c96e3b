"""Action-prediction validation metrics (intact_tpu/utils/metric.py) in torch."""

from __future__ import annotations

from typing import Sequence

import torch


def get_action_accuracy(gt: torch.Tensor, pred: torch.Tensor, thresholds: Sequence[float] = (0.1, 0.2)) -> torch.Tensor:
    """Share of (batch, horizon) frames whose every action dim is within each
    threshold of the ground truth; gt, pred [batch, horizon, action_dim].
    Returns fp32 [len(thresholds)]."""
    diff = (gt - pred).abs().reshape(-1, gt.shape[-1])
    return torch.stack([((diff < t).to(torch.float32).mean(dim=1) >= 1.0).to(torch.float32).mean()
                        for t in thresholds])


def l1_error(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return (gt - pred).abs().mean()
