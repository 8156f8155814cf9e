"""Denoising score-matching loss for SDE training (port of
``fdtpu/diffusion/losses.py:20-92``).

The JAX function takes a PRNG key and splits it for t, z and dropout; here
the three draws come, in that order, from one explicit ``torch.Generator``,
and t and z can be injected instead (``timesteps``, ``noise``), so the loss
can be replayed against the JAX package on the same numbers.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fdtpu_torch.diffusion.sde import SDE
from fdtpu_torch.dist.parallel import draw


def sde_loss(
    network: Callable[..., torch.Tensor],
    scheduler: SDE,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    timesteps: Optional[torch.Tensor] = None,
    reduce_mean: bool = True,
    likelihood_weighting: bool = False,
    train: bool = True,
    sample_weight: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    weight_total: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scalar DSM loss over a mini-batch.

    Args:
        network: ``network(x_noisy, t, train, generator) -> score``, e.g. a
            :class:`~fdtpu_torch.models.score_models.ScoreNetwork`.
        scheduler: VP/VE scheduler.
        x: clean batch ``(B, max_len, n_channels)`` in the model domain.
        generator: draws ``t ~ U[eps, T]`` (unless ``timesteps``), then
            ``z ~ N(0, I)`` (unless ``noise``), then the dropout masks.
        timesteps: optional fixed timesteps ``(B,)``.
        reduce_mean: mean vs 0.5·sum over the data dims.
        likelihood_weighting: Mahalanobis weighting instead of the default
            λ(t) = 1/tr(Σ⁻¹).
        train: enables dropout inside the network.
        sample_weight: optional ``(B,)`` weights; the loss becomes
            ``sum(w·l) / max(sum(w), 1)``.
        noise: optional standard normal ``z`` of x's shape.
        weight_total: the ``sum(w)`` of that denominator when ``x`` is one
            rank's rows of a batch sharded over a mesh (the whole batch's).

    A :class:`~fdtpu_torch.dist.parallel.ShardedGenerator` draws t, z and
    the masks of the whole batch and keeps this rank's rows.
    """
    batch_size = x.shape[0]
    if (timesteps is None or noise is None) and generator is None:
        raise ValueError("sde_loss needs a generator unless timesteps and noise are given")
    if timesteps is None:
        u = draw(torch.rand, (batch_size,), generator, x.device, x.dtype)
        timesteps = u * (scheduler.T - scheduler.eps) + scheduler.eps
    if noise is None:
        noise = draw(torch.randn, x.shape, generator, x.device, x.dtype)

    _, std = scheduler.marginal_prob(x, timesteps)  # (B, max_len)
    var = std**2
    x_noisy = scheduler.add_noise(x, std[..., None] * noise, timesteps)
    target_noise = noise / std[..., None]

    score = network(x_noisy, timesteps, train, generator)

    if not likelihood_weighting:
        weighting = 1.0 / torch.sum(1.0 / var, dim=1)  # (B,)
        losses = weighting[:, None, None] * torch.square(score + target_noise)
    else:
        losses = torch.square(std[..., None] * (score + target_noise))

    losses = losses.reshape(batch_size, -1)
    if reduce_mean:
        losses = torch.mean(losses, dim=-1)
    else:
        losses = 0.5 * torch.sum(losses, dim=-1)
    if sample_weight is not None:
        w = sample_weight.to(losses.dtype)
        total = torch.sum(w) if weight_total is None else weight_total.to(losses.dtype)
        return torch.sum(w * losses) / torch.clamp(total, min=1.0)
    return torch.mean(losses)
