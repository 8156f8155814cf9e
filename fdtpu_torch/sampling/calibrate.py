"""Quality-constrained choice of the score level's skip budget τ₀ (port of
``fdtpu/sampling/calibrate.py:33-182``).

``calibrate_tau_0`` runs one uncached pilot and an independent uncached rerun
(their sliced Wasserstein distance is the noise floor), then walks a
descending τ₀ ladder, sampling cached with the pilot's noise at each arm, and
accepts the first (largest) τ₀ whose samples stay within the floor of the
pilot and whose error-budget guard telemetry stays under its thresholds.
The result carries every arm's evidence.

Noise comes from a ``torch.Generator`` seeded with ``seed`` for the pilot
and every arm (the same draws), and ``seed + 1`` for the floor's rerun, or
is handed in (``prior_noise``/``step_noise`` as ``DiffusionSampler.sample``
takes them; ``floor_prior_noise``/``floor_step_noise`` for the rerun).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Optional, Sequence

import torch

from fdtpu_torch.cache.e2crf import E2CRFConfig
from fdtpu_torch.metrics import SlicedWasserstein
from fdtpu_torch.sampling.sampler import DiffusionSampler
from fdtpu_torch.utils.device import module_device

logger = logging.getLogger(__name__)

#: Descending skip budgets: the first accepted arm is the largest safe one.
DEFAULT_LADDER: tuple[float, ...] = (1.5, 1.2, 1.0, 0.8, 0.6, 0.4)


@dataclasses.dataclass(frozen=True)
class TauArm:
    """Evidence for one ladder arm."""

    tau_0: float
    sw_vs_uncached: float
    steps_skipped_ratio: float
    guard_err_mean: float
    guard_err_max: float
    within_floor: bool
    guard_silent: bool

    @property
    def accepted(self) -> bool:
        return self.within_floor and self.guard_silent


@dataclasses.dataclass(frozen=True)
class TauCalibration:
    """Result of :func:`calibrate_tau_0`; ``tau_0`` is None when no arm
    passed (sample uncached), and ``cache_kwargs`` then has no ``tau_0``."""

    tau_0: Optional[float]
    sw_noise_floor: float
    arms: tuple[TauArm, ...]
    cache_kwargs: dict[str, Any]

    @property
    def accepted(self) -> Optional[TauArm]:
        for arm in self.arms:
            if arm.accepted:
                return arm
        return None


def calibrate_tau_0(
    model,
    *,
    num_samples: int,
    num_diffusion_steps: int,
    sample_batch_size: Optional[int] = None,
    batches_per_call: int = 1,
    seed: int = 0,
    ladder: Sequence[float] = DEFAULT_LADDER,
    cache_kwargs: Optional[dict[str, Any]] = None,
    num_directions: int = 200,
    guard_abs_tol: Optional[float] = None,
    guard_max_tol: Optional[float] = None,
    mesh=None,
    prior_noise: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
    floor_prior_noise: Optional[torch.Tensor] = None,
    floor_step_noise: Optional[torch.Tensor] = None,
) -> TauCalibration:
    """Pick the largest safe τ₀ for ``model`` (a ``ScoreModel``) by pilot
    sampling on the model's device.

    ``cache_kwargs`` seeds the cache configuration other than τ₀ (default
    the score level, R = 100, ``eps_order`` 1); the arms run with the guard
    off.  The guard thresholds default to the configuration's raw
    ``guard_abs_tol`` (0.0 unless set, as in the JAX package) and
    ``guard_max_tol``.  ``batches_per_call`` groups batches as
    :class:`DiffusionSampler` does (the same values); ``mesh`` raises
    ``NotImplementedError``, as the sampler does.
    """
    base_kwargs: dict[str, Any] = {"level": "score", "R": 100, "eps_order": 1}
    base_kwargs.update(cache_kwargs or {})
    base_kwargs.pop("tau_0", None)
    # The arms must not warn about operating points the ladder rejects anyway.
    pilot_kwargs = {**base_kwargs, "guard": "off"}
    probe_cfg = E2CRFConfig(**{k: v for k, v in base_kwargs.items() if hasattr(E2CRFConfig, k)})
    abs_tol = guard_abs_tol if guard_abs_tol is not None else probe_cfg.guard_abs_tol
    max_tol = guard_max_tol if guard_max_tol is not None else probe_cfg.guard_max_tol
    if sample_batch_size is None:
        sample_batch_size = max(1, num_samples // batches_per_call)
    device = module_device(model.network)

    def run(sampler: DiffusionSampler, run_seed: int, prior, steps) -> torch.Tensor:
        generator = torch.Generator(device=device).manual_seed(run_seed)
        return sampler.sample(num_samples, num_diffusion_steps, generator=generator,
                              prior_noise=prior, step_noise=steps)

    uncached = DiffusionSampler(model, sample_batch_size, mesh=mesh,
                                batches_per_call=batches_per_call)
    s_base = run(uncached, seed, prior_noise, step_noise)
    s_base2 = run(uncached, seed + 1, floor_prior_noise, floor_step_noise)
    sw = SlicedWasserstein(original_samples=s_base, random_seed=42, num_directions=num_directions)
    floor = float(sw(s_base2)["sliced_wasserstein_mean"])

    arms: list[TauArm] = []
    chosen: Optional[float] = None
    # One sampler for every arm: only τ₀ differs, so a grouped chain's graphs
    # are captured once and replayed by every arm.
    cached = DiffusionSampler(model, sample_batch_size, use_cache=True,
                              cache_kwargs={**pilot_kwargs, "tau_0": float(ladder[0])},
                              mesh=mesh, batches_per_call=batches_per_call) if ladder else None
    for tau in ladder:
        cached.set_tau_0(tau)
        s_ca = run(cached, seed, prior_noise, step_noise)
        stats = cached.get_cache_stats()
        delta = float(sw(s_ca)["sliced_wasserstein_mean"])
        arm = TauArm(
            tau_0=float(tau),
            sw_vs_uncached=delta,
            steps_skipped_ratio=float(stats["steps_skipped_ratio"]),
            guard_err_mean=float(stats["realized_err_mean"]),
            guard_err_max=float(stats["realized_err_max"]),
            within_floor=delta <= floor,
            guard_silent=(stats["realized_err_mean"] <= abs_tol
                          and stats["realized_err_max"] <= max_tol),
        )
        arms.append(arm)
        logger.info(
            "calibrate_tau_0: tau=%.3g SW %.4g vs floor %.4g, %.0f%% skipped, "
            "guard mean/max %.3g/%.3g -> %s",
            tau, delta, floor, 100 * arm.steps_skipped_ratio, arm.guard_err_mean,
            arm.guard_err_max, "accept" if arm.accepted else "reject",
        )
        if arm.accepted:
            chosen = float(tau)
            break

    return TauCalibration(
        tau_0=chosen,
        sw_noise_floor=floor,
        arms=tuple(arms),
        cache_kwargs={**base_kwargs, "tau_0": chosen} if chosen is not None else dict(base_kwargs),
    )
