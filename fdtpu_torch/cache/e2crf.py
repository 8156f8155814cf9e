"""E²-CRF score-level cache (port of ``fdtpu/cache/e2crf.py:67-382, 458-486,
545-608, 714-784``).

The score level skips the network on whole diffusion steps: a skipped step
rebuilds the score from an extrapolated noise prediction ε̂ rescaled by the
current marginal std (score(t) = −ε̂ / std(t)).  Skipping continues while the
accumulated predicted ε̂ drift stays under τ₀ and the hard interval R has not
expired (error feedback); every refresh measures the realized extrapolation
error for the guard.

The state is a dataclass of tensors on the sampling device.  Its float
statistics (``err_acc``, ``drift_rate``, ``eps_gap``, ``eps_norm_ref`` …) are
float32 0-d tensors, as in the JAX package, so the skip decision near τ₀ is
taken on the same float32 values; the integer counters and the ``cold`` flag
are host values.  Only ``level="score"`` is ported; the token and KV levels
are still to port (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class E2CRFConfig:
    """Cache configuration; same fields and defaults as the JAX package
    (field documentation in ``fdtpu/cache/e2crf.py:67-217``)."""

    K: int = 5
    R: int = 10
    tau_0: float = 0.1
    tau_warn: float = 0.5
    policy: str = "event"  # "event" | "macro"
    level: str = "score"  # "score" | "token" | "kv"
    token_budget: int = 0
    # Score-level skip predictor order: 0 frozen ε̂, 1 linear, 2 quadratic.
    eps_order: int = 1
    random_probe_ratio: float = -1.0
    energy_weighting: bool = True
    use_freqca: bool = False
    freq_decomp: str = "dct"
    low_freq_ratio: float = 0.3
    max_history: int = 10
    hermite_order: int = 3
    freq_decomp_interval: int = 10
    eps_predictor: str = "taylor"  # "taylor" | "freqca"
    # Reference behavior: the cache persists across sample batches (quirk Q5).
    reset_between_batches: bool = False
    # Error-budget guard: "warn" | "strict" | "off", and its tolerances.
    guard: str = "warn"
    guard_overrun_tol: float = 5.0
    guard_abs_tol: float = 0.0  # 0.0 = auto (2.5 score/kv, 1.5 token)
    guard_max_tol: float = 4.0
    # τ₀ auto-calibration from the overrun high-water mark.
    auto_calibrate: bool = False

    @property
    def resolved_random_probe_ratio(self) -> float:
        if self.random_probe_ratio >= 0.0:
            return self.random_probe_ratio
        return 0.02 if self.level == "token" else 0.0

    @property
    def resolved_guard_abs_tol(self) -> float:
        if self.guard_abs_tol:
            return self.guard_abs_tol
        return 1.5 if self.level == "token" else 2.5

    def policy_params(self, device=None) -> "PolicyParams":
        """Numeric policy knobs: float32 tensors where the decision compares
        them with float32 state, host ints for the integer ones."""
        def f32(x: float) -> torch.Tensor:
            return torch.tensor(x, dtype=torch.float32, device=device)

        return PolicyParams(
            K=self.K,
            R=self.R,
            tau_0=f32(self.tau_0),
            tau_warn=f32(self.tau_warn),
            random_probe_ratio=f32(self.resolved_random_probe_ratio),
            guard_abs_tol=f32(self.resolved_guard_abs_tol),
        )


@dataclasses.dataclass(frozen=True)
class PolicyParams:
    K: int
    R: int
    tau_0: torch.Tensor
    tau_warn: torch.Tensor
    random_probe_ratio: torch.Tensor
    guard_abs_tol: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CacheState:
    """Score-level cache state (the score-level fields of the JAX pytree)."""

    eps_hat: torch.Tensor  # (B, T, C) last fully computed noise prediction
    eps_prev: torch.Tensor  # (B, T, C) the full computation before eps_hat
    eps_prev2: torch.Tensor  # (B, T, C) the one before eps_prev
    eps_gap: torch.Tensor  # () steps between eps_prev and eps_hat
    eps_gap2: torch.Tensor  # () steps between eps_prev2 and eps_prev
    drift_rate: torch.Tensor  # () per-step relative ε̂ drift at the last refresh
    err_acc: torch.Tensor  # () accumulated predicted drift since the last refresh
    last_full_step: int
    cold: bool  # no valid ε̂ yet: the next step must run the network
    step: int  # global across batches
    recompute_count: int
    cache_hit_count: int
    full_steps: int
    mixed_steps: int
    cached_steps: int
    realized_err_sum: torch.Tensor  # ()
    predicted_err_sum: torch.Tensor  # ()
    realized_err_max: torch.Tensor  # ()
    guard_measurements: int
    overrun: torch.Tensor  # () high-water mark of realized/predicted
    eps_norm_ref: torch.Tensor  # () high-water mark of the refresh-time ‖ε̂‖
    eps_norm_cold: torch.Tensor  # () ‖ε̂‖ at the cold refresh

    def replace(self, **changes) -> "CacheState":
        return dataclasses.replace(self, **changes)


def init_cache_state(
    cfg: E2CRFConfig,
    batch: int,
    max_len: int,
    n_channels: int,
    device=None,
) -> CacheState:
    if cfg.level != "score":
        raise NotImplementedError(
            f"level={cfg.level!r}: only the score level is ported; the token "
            "and KV levels are ROADMAP.md items"
        )

    def zeros(*shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return CacheState(
        eps_hat=zeros(batch, max_len, n_channels),
        eps_prev=zeros(batch, max_len, n_channels),
        eps_prev2=zeros(batch, max_len, n_channels),
        eps_gap=zeros(),
        eps_gap2=zeros(),
        drift_rate=zeros(),
        err_acc=zeros(),
        last_full_step=0,
        cold=True,
        step=0,
        recompute_count=0,
        cache_hit_count=0,
        full_steps=0,
        mixed_steps=0,
        cached_steps=0,
        realized_err_sum=zeros(),
        predicted_err_sum=zeros(),
        realized_err_max=zeros(),
        guard_measurements=0,
        overrun=torch.ones((), dtype=torch.float32, device=device),
        eps_norm_ref=zeros(),
        eps_norm_cold=zeros(),
    )


def effective_tau(cfg: E2CRFConfig, pp: PolicyParams, state: CacheState) -> torch.Tensor:
    """Skip budget τ₀, or τ₀ / max(1, overrun) with ``auto_calibrate``."""
    if not cfg.auto_calibrate:
        return pp.tau_0
    return pp.tau_0 / torch.clamp(state.overrun, min=1.0)


def score_skip_decision(cfg: E2CRFConfig, pp: PolicyParams, state: CacheState) -> bool:
    """True → run the network this step.

    Run it on a cold cache, on the calibration step right after a cold start
    (drift rate still 0), when the interval R expired, or when the
    accumulated predicted drift reached the budget.  The JAX package takes
    this branch inside ``lax.cond``; here it costs one host read of the
    float32 comparison, and none when the host-side conditions decide."""
    since = state.step - state.last_full_step
    if state.cold or since >= pp.R:
        return True
    decide = state.err_acc >= effective_tau(cfg, pp, state)
    if since == 1:
        decide = decide | (state.drift_rate == 0)
    return bool(decide)


# Per-measurement floor on the predicted budget in the overrun ratio.
GUARD_PREDICTED_FLOOR = 0.05
# Relative-error denominators are floored at this fraction of the
# trajectory-scale ε̂ norm (CacheState.eps_norm_ref).
GUARD_NORM_FLOOR_FRAC = 0.1


def guard_relative_error(
    delta_norm: torch.Tensor, eps_norm: torch.Tensor, norm_ref: torch.Tensor
) -> torch.Tensor:
    """Extrapolation error relative to ``max(‖ε̂‖, 10% of trajectory scale)``."""
    return delta_norm / torch.maximum(eps_norm, GUARD_NORM_FLOOR_FRAC * norm_ref)


def record_guard_measurement(
    state: CacheState,
    measured: bool,
    realized: torch.Tensor,
    predicted: torch.Tensor,
    abs_target: torch.Tensor,
) -> CacheState:
    """Fold one closed skip span's realized-vs-predicted error into the guard
    telemetry (no-op unless ``measured``).  ``overrun`` is a monotone
    high-water mark of the worse of realized/predicted and
    realized/abs_target, clipped to [0, 10]."""
    if not measured:
        return state
    dt = state.realized_err_sum.dtype
    ratio = realized / torch.clamp(predicted, min=GUARD_PREDICTED_FLOOR)
    miscal = torch.clamp(
        torch.maximum(ratio, realized / torch.clamp(abs_target, min=1e-3)), 0.0, 10.0
    ).to(dt)
    return state.replace(
        realized_err_sum=state.realized_err_sum + realized.to(dt),
        predicted_err_sum=state.predicted_err_sum + predicted.to(dt),
        realized_err_max=torch.maximum(state.realized_err_max, realized.to(dt)),
        guard_measurements=state.guard_measurements + 1,
        overrun=torch.maximum(state.overrun, miscal),
    )


def cache_stats(state: CacheState) -> dict[str, Any]:
    """Summary statistics; the same keys as the JAX package's."""
    recompute = state.recompute_count
    hits = state.cache_hit_count
    total = recompute + hits
    total_steps = state.full_steps + state.mixed_steps + state.cached_steps
    n_guard = state.guard_measurements
    realized_sum = float(state.realized_err_sum)
    predicted_sum = float(state.predicted_err_sum)
    peak = float(state.eps_norm_ref)
    cold = float(state.eps_norm_cold)
    numel = state.eps_hat.numel()
    return {
        "cache_hit_ratio": hits / total if total else 0.0,
        "recompute_count": recompute,
        "cache_hit_count": hits,
        "current_step": state.step,
        "full_steps": state.full_steps,
        "mixed_steps": state.mixed_steps,
        "cached_steps": state.cached_steps,
        "steps_skipped_ratio": state.cached_steps / total_steps if total_steps else 0.0,
        "guard_measurements": n_guard,
        "realized_err_mean": realized_sum / n_guard if n_guard else 0.0,
        "predicted_err_mean": predicted_sum / n_guard if n_guard else 0.0,
        "realized_err_max": float(state.realized_err_max),
        "budget_overrun_ratio": (
            realized_sum / max(predicted_sum, n_guard * GUARD_PREDICTED_FLOOR)
            if n_guard
            else 0.0
        ),
        "overrun_mark": float(state.overrun),
        "eps_norm_peak": peak,
        "eps_norm_scale": peak / float(numel) ** 0.5 if numel and peak else 0.0,
        "eps_norm_growth": (
            float(state.eps_norm_ref / torch.clamp(state.eps_norm_cold, min=1e-6))
            if cold > 0
            else 0.0
        ),
    }
