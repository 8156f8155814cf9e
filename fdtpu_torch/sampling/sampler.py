"""Reverse-diffusion sampling (port of ``fdtpu/sampling/sampler.py:99-415,
784-1151``).

The JAX package compiles the whole trajectory into one ``lax.scan``; here the
reverse Euler–Maruyama chain is a Python loop over steps, one score forward
per full step.  At the score level of the E²-CRF cache each step either runs
the network (refresh) or rebuilds the score from the extrapolated ε̂ (skip);
the branch is decided on the host from the float32 cache state.

Noise can be injected: ``sample_chain`` takes ``step_noise`` of shape
``(num_steps, B, T, C)`` and ``DiffusionSampler.sample`` takes ``prior_noise``
``(N, T, C)`` and ``step_noise`` ``(num_steps, N, T, C)``; otherwise the noise
is drawn from a ``torch.Generator``.  JAX and torch random streams never
match, so replaying a JAX chain means handing its draws in.

Reference parity kept on purpose: remainder-dropping batch count (quirk Q6)
and cache persistence across batches with a global step counter, the cache
marked cold for each new trajectory (quirk Q5, opt-out
``reset_between_batches``).
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import torch

from fdtpu_torch.cache.e2crf import (
    CacheState,
    E2CRFConfig,
    PolicyParams,
    cache_stats,
    guard_relative_error,
    init_cache_state,
    record_guard_measurement,
    score_skip_decision,
)
from fdtpu_torch.diffusion.sde import SDE
from fdtpu_torch.models.score_models import ScoreModel, ScoreNetwork
from fdtpu_torch.utils.device import module_device


def _check_cache_config(cfg: E2CRFConfig) -> None:
    if cfg.eps_predictor not in ("taylor", "freqca"):
        raise ValueError(f"eps_predictor must be 'taylor' or 'freqca' (got {cfg.eps_predictor!r})")
    if cfg.level != "score":
        raise NotImplementedError(
            f"level={cfg.level!r} is not ported yet (ROADMAP.md: token level, KV level)"
        )
    if cfg.eps_predictor == "freqca":
        raise NotImplementedError("eps_predictor='freqca' is not ported yet (ROADMAP.md: FreqCa)")


def _prep_cache_for_new_batch(state: CacheState) -> CacheState:
    """Cross-batch cache prep (quirk Q5): keep the store but mark it cold so
    the new trajectory recomputes and re-calibrates its drift rate."""
    return state.replace(cold=True, drift_rate=torch.zeros_like(state.drift_rate))


def eps_predict(c: CacheState, steps_ahead: float, order: int) -> torch.Tensor:
    """Extrapolate ε̂ ``steps_ahead`` past the last full computation: order 0
    frozen reuse, 1 linear from the last two full computations, 2 quadratic
    (Newton form) from the last three."""
    if order == 0:
        return c.eps_hat
    slope1 = torch.where(
        c.eps_gap > 0, (c.eps_hat - c.eps_prev) / torch.clamp(c.eps_gap, min=1), 0.0
    )
    pred = c.eps_hat + slope1 * steps_ahead
    if order >= 2:
        slope2 = torch.where(
            c.eps_gap2 > 0, (c.eps_prev - c.eps_prev2) / torch.clamp(c.eps_gap2, min=1), 0.0
        )
        span = torch.clamp(c.eps_gap + c.eps_gap2, min=1.0) / 2.0
        curvature = torch.where(
            (c.eps_gap > 0) & (c.eps_gap2 > 0), (slope1 - slope2) / span, 0.0
        )
        pred = pred + 0.5 * curvature * steps_ahead * (steps_ahead + c.eps_gap)
    return pred


def _refresh(network, c: CacheState, pp: PolicyParams, x, t_batch, std, order: int):
    """Full step: run the network, measure the drift against what a skip
    would have predicted, and roll the ε̂ history."""
    score = network(x, t_batch)
    eps_new = -std[..., None] * score
    denom = torch.linalg.vector_norm(eps_new) + 1e-8
    # Trajectory noise scale: high-water mark of the refresh-time ‖ε̂‖.
    norm_ref = torch.maximum(c.eps_norm_ref, denom.to(x.dtype))
    steps_since = max(c.step - c.last_full_step, 1)
    zero = torch.zeros_like(c.eps_gap)
    if c.cold:
        rel = drift_rate = zero
    else:
        # The denominator is floored at 10% of the trajectory scale.
        eps_pred = eps_predict(c, float(steps_since), order)
        rel = guard_relative_error(torch.linalg.vector_norm(eps_new - eps_pred), denom, norm_ref)
        drift_rate = rel / steps_since
    measured = (not c.cold) and steps_since > 1
    trace = (float(measured), rel, denom, c.err_acc, float(steps_since))
    # A refresh that closes a real skip span measures the realized error
    # against what the budget predicted (err_acc).
    c = record_guard_measurement(c, measured, rel, c.err_acc, pp.guard_abs_tol)
    cold = c.cold
    c = c.replace(
        eps_norm_ref=norm_ref,
        eps_norm_cold=denom.to(c.eps_norm_cold.dtype) if cold else c.eps_norm_cold,
        cold=False,
        eps_prev2=eps_new if cold else c.eps_prev,
        eps_gap2=zero if cold else c.eps_gap,
        eps_prev=eps_new if cold else c.eps_hat,
        eps_gap=zero if cold else torch.full_like(zero, float(steps_since)),
        eps_hat=eps_new,
        drift_rate=drift_rate,
        err_acc=zero,
        last_full_step=c.step,
        full_steps=c.full_steps + 1,
        recompute_count=c.recompute_count + x.shape[1],
    )
    return score, c, trace


def _skip(c: CacheState, std, max_len: int, order: int):
    """Skipped step: rebuild the score from the predicted noise."""
    eps = eps_predict(c, float(c.step - c.last_full_step + 1), order)
    score = -eps / std[..., None]
    c = c.replace(
        err_acc=c.err_acc + c.drift_rate,
        cached_steps=c.cached_steps + 1,
        cache_hit_count=c.cache_hit_count + max_len,
    )
    return score, c


@torch.no_grad()
def sample_chain(
    network: ScoreNetwork,
    scheduler: SDE,
    x0: torch.Tensor,
    cache_state: Optional[CacheState] = None,
    *,
    cache_cfg: Optional[E2CRFConfig] = None,
    num_steps: int,
    step_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    guard_trace: bool = False,
):
    """Run the reverse diffusion from the prior sample ``x0``.

    Returns ``(x, cache_state)``; with ``guard_trace=True`` (score level)
    also per-step telemetry ``(measured, rel, eps_norm, err_acc,
    steps_since)``, each ``(num_steps,)`` and zero on skipped steps, laid out
    as the JAX package's ``guard_trace``.
    """
    if cache_cfg is not None:
        _check_cache_config(cache_cfg)
    elif guard_trace:
        raise NotImplementedError("guard_trace only supports level='score'")
    network = network.compute_copy()
    ts, step_size = scheduler.timesteps(num_steps, device=x0.device)
    batch = x0.shape[0]

    def noise(i: int, x: torch.Tensor) -> torch.Tensor:
        if step_noise is not None:
            return step_noise[i].to(device=x.device, dtype=x.dtype)
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    x = x0
    if cache_cfg is None:
        for i in range(num_steps):
            t = ts[i]
            score = network(x, t.expand(batch))
            x = scheduler.step(score, t, x, noise(i, x), step_size)
        return x, None

    pp = cache_cfg.policy_params(x0.device)
    order = cache_cfg.eps_order
    max_len = x0.shape[1]
    cache = cache_state
    if cache is None:
        cache = init_cache_state(cache_cfg, batch, max_len, x0.shape[2], x0.device)
    skipped = (0.0, torch.zeros((), device=x.device), torch.zeros((), device=x.device),
               torch.zeros((), device=x.device), 0.0)
    traces = []
    for i in range(num_steps):
        t = ts[i]
        t_batch = t.expand(batch)
        _, std = scheduler.marginal_prob(x, t_batch)
        if score_skip_decision(cache_cfg, pp, cache):
            score, cache, trace = _refresh(network, cache, pp, x, t_batch, std, order)
        else:
            score, cache = _skip(cache, std, max_len, order)
            trace = skipped
        if guard_trace:
            traces.append(trace)
        x = scheduler.step(score, t, x, noise(i, x), step_size)
        cache = cache.replace(step=cache.step + 1)
    if guard_trace:
        columns = tuple(
            torch.stack([torch.as_tensor(tr[j], dtype=torch.float32, device=x.device)
                         for tr in traces])
            for j in range(5)
        )
        return x, cache, columns
    return x, cache


class DiffusionSampler:
    """User-facing sampler (the JAX package's ``DiffusionSampler``).

    ``cache_kwargs`` takes the fields of :class:`E2CRFConfig`.  Not ported
    yet (ROADMAP.md): FreSca, ``mesh`` and ``batches_per_call > 1``.
    """

    def __init__(
        self,
        score_model: ScoreModel,
        sample_batch_size: int,
        use_cache: bool = False,
        cache_kwargs: Optional[dict] = None,
        use_fresca: bool = False,
        mesh: Optional[Any] = None,
        batches_per_call: int = 1,
    ) -> None:
        if use_fresca:
            raise NotImplementedError("FreSca is not ported yet (ROADMAP.md: FreqCa and FreSca)")
        if mesh is not None:
            raise NotImplementedError("mesh is not ported yet (ROADMAP.md: distribution)")
        if batches_per_call > 1:
            raise NotImplementedError(
                "batches_per_call > 1 is not ported yet (ROADMAP.md: graph-captured sampling)"
            )
        self.score_model = score_model
        self.noise_scheduler = score_model.scheduler
        self.sample_batch_size = sample_batch_size
        self.n_channels = score_model.n_channels
        self.max_len = score_model.max_len
        self.device = module_device(score_model.network)
        self.use_cache = use_cache
        self.cache_config = E2CRFConfig(**(cache_kwargs or {})) if use_cache else None
        if self.cache_config is not None:
            _check_cache_config(self.cache_config)
        self.last_cache_state: Optional[CacheState] = None

    def _init_cache(self, batch_size: int) -> Optional[CacheState]:
        if not self.use_cache:
            return None
        return init_cache_state(
            self.cache_config, batch_size, self.max_len, self.n_channels, self.device
        )

    def sample_prior(
        self,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if noise is not None:
            noise = noise.to(self.device)
        return self.noise_scheduler.prior_sampling(
            (batch_size, self.max_len, self.n_channels), generator, self.device, noise
        )

    def sample(
        self,
        num_samples: int,
        num_diffusion_steps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        prior_noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Generate ``num_samples`` series ``(N, T, C)`` on the model's device.

        Remainder-dropping batch count (quirk Q6) and cache persistence
        across batches (quirk Q5).  Noise comes from ``prior_noise`` /
        ``step_noise`` when given (indexed by sample), else from
        ``generator`` (seed 0 on the model's device by default)."""
        if num_diffusion_steps is None:
            num_diffusion_steps = self.score_model.num_training_steps
        if generator is None and (prior_noise is None or step_noise is None):
            generator = torch.Generator(device=self.device).manual_seed(0)

        num_batches = max(1, num_samples // self.sample_batch_size)
        all_samples = []
        cache_state: Optional[CacheState] = None
        for batch_idx in range(num_batches):
            start = batch_idx * self.sample_batch_size
            batch_size = min(num_samples - start, self.sample_batch_size)
            rows = slice(start, start + batch_size)
            x0 = self.sample_prior(
                batch_size, generator, None if prior_noise is None else prior_noise[rows]
            )
            if self.use_cache and (
                cache_state is None
                or self.cache_config.reset_between_batches
                or cache_state.eps_hat.shape[0] != batch_size
            ):
                cache_state = self._init_cache(batch_size)
            elif self.use_cache and batch_idx > 0:
                cache_state = _prep_cache_for_new_batch(cache_state)
            x, cache_state = sample_chain(
                self.score_model.network,
                self.noise_scheduler,
                x0,
                cache_state,
                cache_cfg=self.cache_config,
                num_steps=num_diffusion_steps,
                step_noise=None if step_noise is None else step_noise[:, rows],
                generator=generator,
            )
            all_samples.append(x)

        self.last_cache_state = cache_state
        self._check_error_budget()
        return torch.cat(all_samples, dim=0)

    def _check_error_budget(self) -> None:
        """Collapse detector after every cached ``sample()``: warn (or raise
        under ``guard="strict"``) when the realized extrapolation error runs
        far ahead of the predicted budget or is absolutely large."""
        cfg = self.cache_config
        if cfg is None or cfg.guard == "off" or self.last_cache_state is None:
            return
        stats = self.get_cache_stats()
        if not stats.get("guard_measurements"):
            return
        overrun = stats["budget_overrun_ratio"]
        realized = stats["realized_err_mean"]
        worst = stats["realized_err_max"]
        if (
            overrun <= cfg.guard_overrun_tol
            and realized <= cfg.resolved_guard_abs_tol
            and worst <= cfg.guard_max_tol
        ):
            return
        msg = (
            "E2-CRF error-budget guard: realized extrapolation error "
            f"(mean {realized:.3f}, worst span {worst:.3f} over "
            f"{stats['guard_measurements']} refreshes, "
            f"{overrun:.1f}x the predicted budget) is in the "
            f"distribution-collapse regime (tolerances: mean "
            f"{cfg.resolved_guard_abs_tol}, max {cfg.guard_max_tol}, overrun "
            f"{cfg.guard_overrun_tol}). Lower tau_0 and/or R, or set "
            "cache_kwargs={'auto_calibrate': True} to tighten the budget "
            "automatically. Set guard='off' to silence."
        )
        if cfg.guard == "strict":
            raise RuntimeError(msg)
        warnings.warn(msg, stacklevel=2)

    def get_cache_stats(self) -> dict[str, Any]:
        if self.last_cache_state is None:
            return {}
        return cache_stats(self.last_cache_state)
