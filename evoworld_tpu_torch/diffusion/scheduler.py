"""Euler discrete scheduler with Karras sigmas, as pure functions.

Counterpart of `evoworld_tpu/diffusion/scheduler.py`: the Euler sampler and
the training-side EDM helpers. v-prediction with
    c_in = 1 / sqrt(sigma^2 + 1), c_skip = 1 / (sigma^2 + 1),
    c_out = -sigma / sqrt(sigma^2 + 1), t = 0.25 * log(sigma).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EulerScheduleConfig:
    """Karras sigma-schedule hyperparameters (SVD defaults)."""

    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0


def karras_sigmas(
    num_steps: int,
    config: EulerScheduleConfig = EulerScheduleConfig(),
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """(num_steps + 1,) fp32 sigmas: sigma_max ... sigma_min, then a terminal 0."""
    ramp = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32, device=device)
    inv_rho_min = config.sigma_min ** (1.0 / config.rho)
    inv_rho_max = config.sigma_max ** (1.0 / config.rho)
    sigmas = (inv_rho_max + ramp * (inv_rho_min - inv_rho_max)) ** config.rho
    return torch.cat([sigmas, sigmas.new_zeros(1)])


def sigma_to_timestep(sigma: torch.Tensor) -> torch.Tensor:
    """Continuous timestep conditioning: t = 0.25 * log(sigma)."""
    return 0.25 * torch.log(sigma)


def scale_model_input(sample: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Input preconditioning c_in: sample / sqrt(sigma^2 + 1)."""
    return sample / torch.sqrt(sigma**2 + 1.0)


def denoised_from_v(model_output: torch.Tensor, sample: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Denoised sample from a v-prediction output and the unscaled noisy latent."""
    c_out = -sigma / torch.sqrt(sigma**2 + 1.0)
    c_skip = 1.0 / (sigma**2 + 1.0)
    return model_output * c_out + sample * c_skip


def euler_step(
    model_output: torch.Tensor, sample: torch.Tensor, sigma: torch.Tensor, sigma_next: torch.Tensor
) -> torch.Tensor:
    """One deterministic Euler step from sigma to sigma_next."""
    denoised = denoised_from_v(model_output, sample, sigma)
    derivative = (sample - denoised) / sigma
    return sample + derivative * (sigma_next - sigma)


def edm_precondition(sigma: torch.Tensor):
    """(c_in, c_skip, c_out, timestep) of training-side EDM."""
    c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
    c_skip = 1.0 / (sigma**2 + 1.0)
    c_out = -sigma / torch.sqrt(sigma**2 + 1.0)
    return c_in, c_skip, c_out, sigma_to_timestep(sigma)


def edm_loss_weight(sigma: torch.Tensor) -> torch.Tensor:
    """EDM MSE weighting (1 + sigma^2) / sigma^2."""
    return (1.0 + sigma**2) / sigma**2


def rand_log_normal(
    shape: tuple[int, ...],
    loc: float,
    scale: float,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """sigma ~ exp(N(loc, scale^2)), fp32, drawn from `generator` on `device`."""
    return torch.exp(loc + scale * torch.randn(shape, generator=generator, device=device, dtype=torch.float32))
