"""VP / VE SDE schedulers (port of ``fdtpu/diffusion/sde.py:32-182``).

Immutable dataclasses: ``with_noise_scaling`` returns a copy holding the
diagonal Fourier noise scaling ``G`` on a device.  ``step`` takes the reverse
noise explicitly and ``prior_sampling`` draws from an explicit
``torch.Generator``, so a chain can be replayed noise for noise.  The
Euler–Maruyama update is ``x ← x − drift·Δt + √Δt · diag(√β·G) · z``, with
``diag(G)`` applied as a broadcast.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from fdtpu_torch.dist.parallel import draw


def noise_scaling_vector(
    max_len: int, fourier_noise_scaling: bool, device=None
) -> torch.Tensor:
    """Diagonal scaling G ``(max_len,)``: 1/√2 everywhere except the DC and
    (even length) Nyquist rows when ``fourier_noise_scaling``, else ones."""
    if not fourier_noise_scaling:
        return torch.ones((max_len,), dtype=torch.float32, device=device)
    g = torch.full((max_len,), 1.0 / math.sqrt(2.0), dtype=torch.float32)
    g[0] = 1.0
    if max_len % 2 == 0:
        g[max_len // 2] = 1.0
    return g.to(device)


@dataclasses.dataclass(frozen=True, eq=False)
class SDE:
    """Base SDE scheduler.  ``G`` is set by :meth:`with_noise_scaling`."""

    fourier_noise_scaling: bool = False
    eps: float = 1e-5
    G: Optional[torch.Tensor] = None

    @property
    def T(self) -> float:
        return 1.0

    def with_noise_scaling(self, max_len: int, device=None) -> "SDE":
        """Finish initialization by computing G for a series length."""
        return dataclasses.replace(
            self, G=noise_scaling_vector(max_len, self.fourier_noise_scaling, device)
        )

    def _g(self, x: torch.Tensor) -> torch.Tensor:
        g = self.G
        if g is None:
            g = noise_scaling_vector(x.shape[1], self.fourier_noise_scaling)
        return g.to(device=x.device, dtype=x.dtype)

    def timesteps(self, num_diffusion_steps: int, device=None):
        """Reverse-time grid ``linspace(1.0, eps, N)`` and the positive step.

        The grid is built in float32 on the host as ``start·(1−s) + stop·s``
        with ``s = i/(N−1)``, one rounding per operation, which is how
        ``jnp.linspace`` forms it; ``torch.linspace`` forms it differently and
        can differ in the last place."""
        n = num_diffusion_steps
        if n < 2:
            raise ValueError(f"need at least 2 diffusion steps, got {n}")
        start, stop = np.float32(1.0), np.float32(self.eps)
        s = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
        grid = start * (np.float32(1.0) - s) + stop * s
        grid = np.concatenate([grid, [stop]]).astype(np.float32)
        ts = torch.from_numpy(grid).to(device)
        return ts, ts[0] - ts[1]

    def marginal_prob(self, x: torch.Tensor, t: torch.Tensor):
        raise NotImplementedError

    def step(self, model_output, timestep, sample, noise, step_size) -> torch.Tensor:
        raise NotImplementedError

    def add_noise(
        self, original_samples: torch.Tensor, noise: torch.Tensor, t: torch.Tensor
    ) -> torch.Tensor:
        """Forward perturbation ``mean(x, t) + noise``; ``noise`` is already
        scaled by diag(std)."""
        mean, _ = self.marginal_prob(original_samples, t)
        return mean + noise

    def prior_sampling(
        self,
        shape: tuple[int, ...],
        generator: Optional[torch.Generator] = None,
        device=None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``G·z`` with ``z ~ N(0, I)`` drawn from ``generator``, or ``noise``
        when it is given (a replayed draw)."""
        if noise is None:
            if device is None:
                device = self.G.device if self.G is not None else "cpu"
            noise = draw(torch.randn, shape, generator, device)
        g = self.G
        if g is None:
            g = noise_scaling_vector(shape[1], self.fourier_noise_scaling)
        return g.to(noise.device)[None, :, None] * noise


@dataclasses.dataclass(frozen=True, eq=False)
class VEScheduler(SDE):
    """Variance-exploding SDE."""

    sigma_min: float = 0.01
    sigma_max: float = 50.0

    def marginal_prob(self, x, t):
        g = self._g(x)
        sigma_t = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        std = sigma_t.reshape(-1, 1) * g[None, :]
        return x, std

    def prior_sampling(self, shape, generator=None, device=None, noise=None):
        return self.sigma_max * super().prior_sampling(shape, generator, device, noise)

    def step(self, model_output, timestep, sample, noise, step_size):
        g = self._g(sample)
        log_ratio = math.log(self.sigma_max / self.sigma_min)
        sqrt_derivative = (
            self.sigma_min
            * math.sqrt(2.0 * log_ratio)
            * (self.sigma_max / self.sigma_min) ** timestep
        )
        diffusion = sqrt_derivative * g  # (max_len,)
        drift = -(diffusion**2)[None, :, None] * model_output
        return (
            sample
            - drift * step_size
            + torch.sqrt(step_size) * diffusion[None, :, None] * noise
        )


@dataclasses.dataclass(frozen=True, eq=False)
class VPScheduler(SDE):
    """Variance-preserving SDE."""

    beta_min: float = 0.1
    beta_max: float = 20.0

    def _log_mean_coeff(self, t):
        return -0.25 * t**2 * (self.beta_max - self.beta_min) - 0.5 * t * self.beta_min

    def marginal_prob(self, x, t):
        g = self._g(x)
        log_mean_coeff = self._log_mean_coeff(t)
        mean = torch.exp(log_mean_coeff).reshape((-1,) + (1,) * (x.ndim - 1)) * x
        std = torch.sqrt(1.0 - torch.exp(2.0 * log_mean_coeff)).reshape(-1, 1) * g[None, :]
        return mean, std

    def get_beta(self, timestep):
        return self.beta_min + timestep * (self.beta_max - self.beta_min)

    def step(self, model_output, timestep, sample, noise, step_size):
        g = self._g(sample)
        beta = self.get_beta(timestep)
        diffusion = torch.sqrt(beta) * g  # (max_len,)
        drift = -0.5 * beta * sample - (diffusion**2)[None, :, None] * model_output
        return (
            sample
            - drift * step_size
            + torch.sqrt(step_size) * diffusion[None, :, None] * noise
        )
