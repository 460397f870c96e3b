"""Rotary position embedding, Gemma/PaliGemma convention.

Half-split layout (first half = "real", second half = "imag" lanes), default
base 10_000, angles computed in fp32 whatever the activation dtype; the
result is cast back to the input dtype.
"""

from __future__ import annotations

import torch


def apply_rope(
    x: torch.Tensor,  # [B, T, H, D]
    positions: torch.Tensor,  # [B, T]
    base: float = 10_000.0,
) -> torch.Tensor:
    d_half = x.shape[-1] // 2
    freq_exponents = (2.0 / x.shape[-1]) * torch.arange(
        d_half, dtype=torch.float32, device=x.device
    )
    inv_freq = base ** (-freq_exponents)  # [D/2]
    angle = positions[..., None].to(torch.float32) * inv_freq[None, None, :]
    angle = angle[:, :, None, :]  # [B, T, 1, D/2]
    sin, cos = torch.sin(angle), torch.cos(angle)

    x32 = x.to(torch.float32)
    x1, x2 = x32[..., :d_half], x32[..., d_half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
