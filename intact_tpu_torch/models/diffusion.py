"""Gaussian diffusion for action decoding, DDPM and DDIM (intact_tpu/models/diffusion.py).

Epsilon-prediction objective, linear and squaredcos_cap_v2 schedules, DDPM
ancestral sampling and DDIM over a strided timestep subset, generic over a
denoiser `eps_fn(x_t, t_int [B], cond) -> eps`. The samplers are Python
loops over the timesteps. Draws: training takes its timesteps and noise
from a numpy Generator (or given), the samplers their noise from a
torch.Generator (or `init_noise`); the reference's JAX key streams have no
counterpart.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    num_timesteps: int = 100
    betas: tuple = ()  # filled by make_schedule

    @property
    def alphas_cumprod(self) -> torch.Tensor:
        """fp32 [T] on the CPU."""
        return torch.cumprod(1.0 - torch.tensor(self.betas, dtype=torch.float32), dim=0)


def make_schedule(num_timesteps: int = 100, kind: str = "squaredcos_cap_v2") -> DiffusionSchedule:
    if kind == "linear":
        scale = 1000 / num_timesteps
        betas = np.linspace(scale * 1e-4, scale * 0.02, num_timesteps)
    elif kind == "squaredcos_cap_v2":
        t = np.arange(num_timesteps + 1) / num_timesteps

        def f(u):
            return np.cos((u + 0.008) / 1.008 * np.pi / 2) ** 2

        betas = np.clip(1 - f(t[1:]) / f(t[:-1]), 0, 0.999)
    else:
        raise ValueError(f"unknown schedule {kind!r}")
    return DiffusionSchedule(num_timesteps=num_timesteps, betas=tuple(float(b) for b in betas))


def q_sample(schedule: DiffusionSchedule, x0: torch.Tensor, t_int: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Forward process: x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps."""
    acp = schedule.alphas_cumprod.to(x0.device)[t_int.long()]
    acp = acp.reshape(*acp.shape, *([1] * (x0.ndim - acp.ndim)))
    return torch.sqrt(acp) * x0 + torch.sqrt(1 - acp) * noise


def training_loss(schedule: DiffusionSchedule, eps_fn, rng: np.random.Generator | None, x0: torch.Tensor,
                  cond=None, t_int: torch.Tensor | None = None, noise: torch.Tensor | None = None):
    """Epsilon-MSE with uniform timesteps -> (mean, {"mse", "losses"}).
    `rng` draws the timesteps and the noise that are not given."""
    b = x0.shape[0]
    if t_int is None:
        t_int = torch.from_numpy(rng.integers(0, schedule.num_timesteps, size=b).astype(np.int32)).to(x0.device)
    if noise is None:
        noise = torch.from_numpy(rng.standard_normal(tuple(x0.shape), dtype=np.float32)).to(x0.device)
    x_t = q_sample(schedule, x0, t_int, noise)
    losses = torch.square(eps_fn(x_t, t_int, cond) - noise)
    return losses.mean(), {"mse": losses.mean(), "losses": losses}


def _start(generator, shape, init_noise):
    if init_noise is not None:
        return init_noise.to(torch.float32)
    return torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=torch.float32)


def ddpm_sample(schedule: DiffusionSchedule, eps_fn, generator: torch.Generator | None, shape, cond=None,
                clip_value: float | None = None, init_noise: torch.Tensor | None = None,
                step_noise=None) -> torch.Tensor:
    """Ancestral sampling over all T steps. `clip_value` clips x to [-v, v]
    after every step (Octo's per-step clipping); `init_noise` fixes x_T.
    The per-step noise comes from `generator`, or from `step_noise` (the
    draws of the steps t = T-1 .. 1, in that order), which replays another
    sampler's draws."""
    x = _start(generator, shape, init_noise)
    betas = torch.tensor(schedule.betas, dtype=torch.float32, device=x.device)
    alphas = 1.0 - betas
    acp = torch.cumprod(alphas, dim=0)
    acp_prev = torch.cat([torch.ones_like(acp[:1]), acp[:-1]])
    post_var = betas * (1 - acp_prev) / (1 - acp)
    for t in range(schedule.num_timesteps - 1, -1, -1):
        eps = eps_fn(x, torch.full((shape[0],), t, dtype=torch.int32, device=x.device), cond)
        mean = (x - betas[t] / torch.sqrt(1 - acp[t]) * eps) / torch.sqrt(alphas[t])
        if t > 0:
            if step_noise is None:
                noise = torch.randn(tuple(shape), generator=generator, device=x.device, dtype=torch.float32)
            else:
                noise = step_noise[schedule.num_timesteps - 1 - t].to(x.device, torch.float32)
            mean = mean + torch.sqrt(post_var[t]) * noise
        x = mean if clip_value is None else mean.clamp(-clip_value, clip_value)
    return x


def ddim_sample(schedule: DiffusionSchedule, eps_fn, generator: torch.Generator | None, shape, cond=None,
                num_steps: int = 10, eta: float = 0.0, init_noise: torch.Tensor | None = None) -> torch.Tensor:
    """DDIM over every `T // num_steps`-th timestep from T - 1 down (the
    reference's respacing). `eta` interpolates deterministic DDIM (0) to
    DDPM-variance (1); the last step is always noise-free. `init_noise`
    fixes x_T; `generator` draws x_T otherwise, and the noise of eta > 0."""
    x = _start(generator, shape, init_noise)
    acp = schedule.alphas_cumprod.to(x.device)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    stride = max(schedule.num_timesteps // num_steps, 1)
    ts = list(range(schedule.num_timesteps - 1, -1, -stride))
    for idx, t in enumerate(ts):
        t_prev = ts[idx + 1] if idx + 1 < len(ts) else -1
        eps = eps_fn(x, torch.full((shape[0],), t, dtype=torch.int32, device=x.device), cond)
        a_t = acp[t]
        a_prev = acp[t_prev] if t_prev >= 0 else one
        x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        sigma = eta * torch.sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev))
        dir_x = torch.sqrt(torch.clamp(1 - a_prev - sigma**2, min=0.0)) * eps
        x = torch.sqrt(a_prev) * x0 + dir_x
        if eta and t_prev >= 0:
            x = x + sigma * torch.randn(tuple(shape), generator=generator, device=x.device, dtype=torch.float32)
    return x


def timestep_embedding(t_int: torch.Tensor, dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    """DDPM sinusoidal timestep embedding [B] -> [B, dim] (fp32)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t_int.device) / half)
    angles = t_int.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
