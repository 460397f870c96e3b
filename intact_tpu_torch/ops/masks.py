"""Attention-mask construction (big_vision / Pi0 convention).

`att_masks` is an int[B, N] where 1 marks the START of a new attention block
and 0 continues the previous block; a token may attend to any valid token
whose cumulative block index is <= its own. This one primitive expresses
causal, prefix-LM, and the Pi0 layout (image+language | state | actions).
"""

from __future__ import annotations

import torch


def make_att_2d_masks(pad_masks: torch.Tensor, att_masks: torch.Tensor) -> torch.Tensor:
    """[B, N] pad + block-start masks -> bool[B, N, N] attention mask.

    out[b, i, j] = pad[b, j] and (cumsum(att)[b, j] <= cumsum(att)[b, i])
    """
    if att_masks.ndim != 2 or pad_masks.ndim != 2:
        raise ValueError(
            f"expected 2D masks, got att {att_masks.ndim}D / pad {pad_masks.ndim}D"
        )
    cum = torch.cumsum(att_masks.to(torch.int32), dim=1)
    att_2d = cum[:, None, :] <= cum[:, :, None]
    return att_2d & pad_masks[:, None, :].to(torch.bool)
