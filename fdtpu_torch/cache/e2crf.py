"""E²-CRF cache at the score, token and KV levels, with FreqCa (port of
``fdtpu/cache/e2crf.py:67-784``).

* Score level: a skipped step rebuilds the score from an extrapolated noise
  prediction ε̂ rescaled by the current marginal std (score(t) = −ε̂ / std(t)).
  Skipping continues while the accumulated predicted ε̂ drift stays under τ₀
  and the hard interval R has not expired (error feedback); every refresh
  measures the realized extrapolation error for the guard.
* Token level (:func:`token_policy`): each step is FULL (refresh every token
  and the K/V store), TOPK (recompute the ``token_budget`` highest-priority
  tokens) or SKIP (extrapolate every token's ε̂).
* KV level (:func:`macro_policy`, :func:`event_policy`,
  :func:`update_after_forward`): every step runs the network, in MODE_FULL,
  MODE_MIXED (fresh K/V for the masked tokens) or MODE_CACHED (stored K/V).
* FreqCa: a ring of the last ``max_history`` high-frequency parts, with the
  low-frequency part of the newest, for a Hermite extrapolation; of the CRF
  at the KV level (``use_freqca``), of ε̂ at the score level
  (``eps_predictor="freqca"``).

The state is a dataclass of tensors on the sampling device.  Its float
statistics (``err_acc``, ``drift_rate``, ``delta_tok``, ``eps_norm_ref`` …)
are float32 tensors, as in the JAX package, so every decision near τ₀ is
taken on the same float32 values.  The step counters and the ``cold`` flag
(:data:`COUNTERS`) are host ints at a chain's boundary; inside a chain they
are one int64 device vector, as the JAX ``CacheState`` keeps them on the
device (:func:`counters_of`, :func:`counter_view`, :func:`with_counters`),
so that the resident chain (:mod:`fdtpu_torch.sampling.resident`) reads
nothing from the device.  Each decision has one definition that returns a
0-d int64 tensor (:func:`score_skip_decision`, :func:`token_policy`,
:func:`event_policy`, :func:`macro_mode`, :func:`kv_ring_due`), and the
counters one update (:func:`count_mode`); both take the counters as host ints
or as 0-d tensors alike.  The eager chain reads the decision with one
``.item()``; the resident chain hands it to a conditional graph node.
Fields a level does not use are zero-size placeholders with the JAX
package's shapes.  The ring's live count ``hist_len`` is a device tensor, so
a FreqCa prediction reads nothing back from the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from fdtpu_torch.dist.parallel import Group, batch_mean
from fdtpu_torch.ops.fourier import frequency_decompose_fft, predict_hermite

MODE_FULL = 0
MODE_MIXED = 1
MODE_CACHED = 2

TOKEN_FULL = 0
TOKEN_TOPK = 1
TOKEN_SKIP = 2


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
    """Cache state (the JAX pytree's fields)."""

    k: torch.Tensor  # (num_layers, B, T, H, Dh) K store, token and KV levels
    v: torch.Tensor  # (num_layers, B, T, H, Dh) V store
    crf_prev: torch.Tensor  # (num_layers, T, d_model) KV level: last step's hidden states (batch 0)
    # Per-token drift: KV level the CRF drift of the last step; token level
    # each token's relative ε̂ extrapolation-residual rate at its last recompute.
    delta_tok: torch.Tensor  # (T,)
    gap_tok: torch.Tensor  # (T,) token level: steps between a token's last two recomputes
    last_tok: torch.Tensor  # (T,) int32, token level: step of each token's last recompute
    eps_hat: torch.Tensor  # (B, T, C) last fully computed noise prediction
    eps_prev: torch.Tensor  # (B, T, C) the full computation before eps_hat
    eps_prev2: torch.Tensor  # (B, T, C) the one before eps_prev
    eps_gap: torch.Tensor  # () steps between eps_prev and eps_hat
    eps_gap2: torch.Tensor  # () steps between eps_prev2 and eps_prev
    drift_rate: torch.Tensor  # () per-step relative ε̂ drift at the last refresh
    err_acc: torch.Tensor  # () accumulated predicted drift since the last refresh
    last_full_step: int
    cold: bool  # no valid ε̂ yet: the next step must run the network
    # FreqCa's history ring, newest last: KV level (use_freqca) the CRF's
    # parts, (max_history, L, T, D); score level (eps_predictor="freqca")
    # ε̂'s, (max_history, B, T, C).  crf_low is the newest low-frequency part.
    crf_low: torch.Tensor
    crf_high_hist: torch.Tensor
    crf_t_hist: torch.Tensor  # (max_history,) the entries' timesteps
    hist_len: torch.Tensor  # () int32, live entries (the trailing ones)
    step: int  # global across batches
    recompute_count: int
    cache_hit_count: int
    full_steps: int
    mixed_steps: int
    cached_steps: int
    realized_err_sum: torch.Tensor  # ()
    predicted_err_sum: torch.Tensor  # ()
    realized_err_max: torch.Tensor  # ()
    # () int32; one type from the start, so a captured graph can update it.
    guard_measurements: torch.Tensor
    overrun: torch.Tensor  # () high-water mark of realized/predicted
    # () high-water mark of the refresh-time ‖ε̂‖, and ‖ε̂‖ at the cold
    # refresh; per token, (T,), at the token level.
    eps_norm_ref: torch.Tensor
    eps_norm_cold: torch.Tensor

    def replace(self, **changes) -> "CacheState":
        return dataclasses.replace(self, **changes)


def check_level(cfg: E2CRFConfig) -> None:
    """A level this package runs: score, token or KV (each with the JAX
    package's options, FreqCa included)."""
    if cfg.level not in ("score", "token", "kv"):
        raise ValueError(f"level must be 'score', 'token' or 'kv', got {cfg.level!r}")


def init_cache_state(
    cfg: E2CRFConfig,
    batch: int,
    max_len: int,
    n_channels: int,
    device=None,
    *,
    num_layers: int = 0,
    n_head: int = 0,
    head_dim: int = 0,
    d_model: int = 0,
    kv_dtype: torch.dtype = torch.float32,
) -> CacheState:
    """Allocate the state the configured level uses, with the JAX package's
    shapes; unused fields are zero-size placeholders.  The token and KV
    levels need the model's ``num_layers``, ``n_head``, ``head_dim`` and
    (KV level) ``d_model``; ``kv_dtype``, the K/V store's and ``crf_prev``'s
    dtype, should be the model's compute dtype."""
    check_level(cfg)
    level = cfg.level
    if level in ("token", "kv") and min(num_layers, n_head, head_dim) < 1:
        raise ValueError(f"level={level!r} needs num_layers, n_head and head_dim")
    if level == "kv" and d_model < 1:
        raise ValueError("level='kv' needs d_model")

    def zeros(*shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=device)

    kv_shape = (num_layers, batch, max_len, n_head, head_dim) if level != "score" else (0,)
    crf_shape = (num_layers, max_len, d_model) if level == "kv" else (0,)
    eps_shape = (batch, max_len, n_channels) if level != "kv" else (0,)
    tok_shape = (max_len,) if level == "token" else (0,)
    norm_shape = (max_len,) if level == "token" else ()
    # The history ring: CRF features at the KV level, ε̂ at the score level.
    if cfg.use_freqca and level == "kv":
        hist_shape = (cfg.max_history, num_layers, max_len, d_model)
    elif level == "score" and cfg.eps_predictor == "freqca":
        hist_shape = (cfg.max_history, batch, max_len, n_channels)
    else:
        hist_shape = (0,)
    has_hist = len(hist_shape) > 1
    hist_dtype = kv_dtype if level == "kv" else torch.float32
    return CacheState(
        k=zeros(*kv_shape, dtype=kv_dtype),
        v=zeros(*kv_shape, dtype=kv_dtype),
        crf_prev=zeros(*crf_shape, dtype=kv_dtype),
        delta_tok=zeros(max_len),
        gap_tok=zeros(*tok_shape),
        last_tok=zeros(*tok_shape, dtype=torch.int32),
        eps_hat=zeros(*eps_shape),
        eps_prev=zeros(*eps_shape),
        eps_prev2=zeros(*((batch, max_len, n_channels) if level == "score" else (0,))),
        eps_gap=zeros(),
        eps_gap2=zeros(),
        drift_rate=zeros(),
        err_acc=zeros(),
        last_full_step=0,
        cold=True,
        crf_low=zeros(*(hist_shape[1:] if has_hist else (0,)), dtype=hist_dtype),
        crf_high_hist=zeros(*hist_shape, dtype=hist_dtype),
        crf_t_hist=zeros(cfg.max_history if has_hist else 0),
        hist_len=zeros(dtype=torch.int32),
        step=0,
        recompute_count=0,
        cache_hit_count=0,
        full_steps=0,
        mixed_steps=0,
        cached_steps=0,
        realized_err_sum=zeros(),
        predicted_err_sum=zeros(),
        realized_err_max=zeros(),
        guard_measurements=zeros(dtype=torch.int32),
        overrun=torch.ones((), dtype=torch.float32, device=device),
        eps_norm_ref=zeros(*norm_shape),
        eps_norm_cold=zeros(*norm_shape),
    )


# ----------------------------------------------------------------- counters
# The step counters of CacheState, in the order of a chain's device vector.
COUNTERS = ("step", "last_full_step", "cold", "recompute_count", "cache_hit_count",
            "full_steps", "mixed_steps", "cached_steps")


def counters_of(state: CacheState, device=None) -> torch.Tensor:
    """The state's counters as an int64 vector on ``device`` (a host copy)."""
    return torch.tensor([int(getattr(state, n)) for n in COUNTERS], dtype=torch.int64,
                        device=device)


def counter_view(state: CacheState, counters: torch.Tensor) -> CacheState:
    """The state with each counter a 0-d view into ``counters`` (a chain's
    vector, :data:`COUNTERS` order)."""
    return state.replace(**{n: counters[i] for i, n in enumerate(COUNTERS)})


def with_counters(state: CacheState, values) -> CacheState:
    """The state with host counters from ``values`` (:data:`COUNTERS`
    order, read from a chain's vector)."""
    host = {n: int(v) for n, v in zip(COUNTERS, values)}
    host["cold"] = bool(host["cold"])
    return state.replace(**host)


def _on(value, device) -> torch.Tensor:
    """A host value as a tensor on ``device``; a tensor as it is."""
    return value if isinstance(value, torch.Tensor) else torch.tensor(value, device=device)


# ----------------------------------------------------------------- policies
# Each decision takes the counters as host ints or 0-d device tensors and
# returns a 0-d int64 tensor (a bool tensor for the *_due parts).
def macro_policy(
    pp: PolicyParams, state: CacheState, max_len: int, device=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's live KV policy: step 0 → FULL; every ``500 if R < 100
    else R`` global steps → MIXED over the first min(2K, T) tokens;
    otherwise → CACHED.  Returns ``(mode, mask (T,) bool, number of masked
    tokens)``; the mask is a device comparison against the count."""
    mode, count = macro_mode(pp, state, max_len, device)
    return mode, torch.arange(max_len, device=count.device) < count, count


def macro_mode(pp: PolicyParams, state: CacheState, max_len: int,
               device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`macro_policy`'s mode and count of recomputed tokens (the mask
    is the first ``count`` tokens)."""
    step = _on(state.step, device)
    interval = 500 if pp.R < 100 else pp.R
    mode = torch.where(step == 0, MODE_FULL,
                       torch.where(step % interval == 0, MODE_MIXED, MODE_CACHED))
    refresh = min(2 * min(pp.K, max_len), max_len)
    count = torch.where(mode == MODE_FULL, max_len, torch.where(mode == MODE_MIXED, refresh, 0))
    return mode.to(torch.int64), count.to(torch.int64)


def event_policy_terms(
    cfg: E2CRFConfig,
    pp: PolicyParams,
    state: CacheState,
    x: torch.Tensor,
    probe_u: Optional[torch.Tensor] = None,
    group: Group = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The event policy's token mask (T,) bool and its warning: the mean
    drift past τ_warn.  ``x`` may be one rank's rows of the batch: ``group``
    (:mod:`fdtpu_torch.dist.parallel`) holds the others."""
    max_len = x.shape[1]
    if cfg.energy_weighting:
        energy = batch_mean(x**2, (0, 2), group)  # (T,)
        energy_w = energy / (torch.mean(energy) + 1e-8)
    else:
        energy_w = torch.ones((max_len,), dtype=x.dtype, device=x.device)
    mask = (state.delta_tok * energy_w > pp.tau_0) | (
        torch.arange(max_len, device=x.device) < min(pp.K, max_len)
    )
    if cfg.resolved_random_probe_ratio > 0.0:
        mask = mask | (probe_u < pp.random_probe_ratio)
    return mask, torch.mean(state.delta_tok) > pp.tau_warn


def event_refresh_due(pp: PolicyParams, state: CacheState):
    """The event policy's full refresh by the counters: step 0 or the
    interval R expired."""
    return (state.step == 0) | (state.step - state.last_full_step >= pp.R)


def event_mode(due, warn: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """FULL when due or warned, else MIXED if any token is masked, else
    CACHED."""
    return torch.where(due | warn, MODE_FULL,
                       torch.where(count > 0, MODE_MIXED, MODE_CACHED)).to(torch.int64)


def event_policy(
    cfg: E2CRFConfig,
    pp: PolicyParams,
    state: CacheState,
    x: torch.Tensor,
    probe_u: Optional[torch.Tensor] = None,
    group: Group = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Event-driven KV policy: the tokens whose energy-weighted CRF drift
    exceeds τ₀, ∪ the K lowest-frequency tokens, ∪ a random probe fraction
    (``probe_u`` (T,) uniforms, read when the probe ratio is positive) are
    recomputed (MIXED, or CACHED if none); a full refresh at step 0, every R
    steps, or when the mean drift exceeds τ_warn.  Returns ``(mode, mask,
    number of masked tokens)``."""
    mask, warn = event_policy_terms(cfg, pp, state, x, probe_u, group)
    mode = event_mode(event_refresh_due(pp, state), warn, mask.sum())
    full = mode == MODE_FULL
    mask = mask | full
    return mode, mask, mask.sum()


def effective_tau(cfg: E2CRFConfig, pp: PolicyParams, state: CacheState) -> torch.Tensor:
    """Skip budget τ₀, or τ₀ / max(1, overrun) with ``auto_calibrate``."""
    if not cfg.auto_calibrate:
        return pp.tau_0
    return pp.tau_0 / torch.clamp(state.overrun, min=1.0)


def score_skip_decision(cfg: E2CRFConfig, pp: PolicyParams, state: CacheState) -> torch.Tensor:
    """1 → run the network this step, 0 → skip it (the JAX predicate that
    ``lax.cond`` takes).

    Run it on a cold cache, on the calibration step right after a cold start
    (drift rate still 0), when the interval R expired, or when the
    accumulated predicted drift reached the budget."""
    since = state.step - state.last_full_step
    calibration = (state.drift_rate == 0) & (since == 1)
    budget = state.err_acc >= effective_tau(cfg, pp, state)
    return (budget | calibration | (since >= pp.R) | (state.cold != 0)).to(torch.int64)


def token_policy_terms(
    cfg: E2CRFConfig,
    pp: PolicyParams,
    state: CacheState,
    x: torch.Tensor,
    group: Group = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The token policy's arithmetic: the energy-weighted drift ``w_drift``
    (T,), its mean, the calibration flag (every per-token rate 0) and the
    skip flag (the predicted accumulated error within the budget); ``group``
    as in :func:`event_policy_terms`."""
    max_len = x.shape[1]
    if cfg.energy_weighting:
        energy = batch_mean(x.float() ** 2, tuple(i for i in range(x.ndim) if i != 1), group)
        energy_w = energy / (torch.mean(energy) + 1e-8)
    else:
        energy_w = torch.ones((max_len,), dtype=torch.float32, device=x.device)
    w_drift = state.delta_tok.float() * energy_w
    mean_drift = torch.mean(w_drift)
    age_next = (state.step - state.last_tok + 1).float()
    skip = torch.mean(w_drift * age_next) <= effective_tau(cfg, pp, state)
    calibration = torch.sum(state.delta_tok) == 0
    return w_drift, mean_drift, calibration, skip


def token_refresh_due(pp: PolicyParams, state: CacheState):
    """The token level's FULL step by the counters: a cold cache or the
    interval R expired."""
    return (state.cold != 0) | (state.step - state.last_full_step >= pp.R)


def token_mode(pp: PolicyParams, state: CacheState, calibration: torch.Tensor,
               skip: torch.Tensor) -> torch.Tensor:
    """FULL when due or on the calibration step right after a refresh, else
    SKIP within the budget, else TOPK."""
    since = state.step - state.last_full_step
    full = token_refresh_due(pp, state) | (calibration & (since == 1))
    return torch.where(full, TOKEN_FULL,
                       torch.where(skip, TOKEN_SKIP, TOKEN_TOPK)).to(torch.int64)


def token_policy(
    cfg: E2CRFConfig, pp: PolicyParams, state: CacheState, x: torch.Tensor, group: Group = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step mode of the token level: TOKEN_FULL on a cold cache, on the
    calibration step right after a refresh whose per-token rates are all 0,
    or when R expired; TOKEN_SKIP while the predicted accumulated error
    ``mean(w_drift × (age + 1))`` stays within the budget; else TOKEN_TOPK.

    Returns ``(mode, w_drift (T,), mean_drift ())``, float32, with the
    energy-weighted drift ``w_drift``."""
    w_drift, mean_drift, calibration, skip = token_policy_terms(cfg, pp, state, x, group)
    return token_mode(pp, state, calibration, skip), w_drift, mean_drift


def kv_ring_due(cfg: E2CRFConfig, state: CacheState, device=None) -> torch.Tensor:
    """Whether this KV-level step adds an entry to FreqCa's ring."""
    step = _on(state.step, device)
    return (step % cfg.freq_decomp_interval == 0) & cfg.use_freqca


def count_mode(state: CacheState, level: str, mode, max_len: int, n_recomputed=None):
    """The counters after a step in ``mode`` (the JAX bodies' counting):
    at the score level ``mode`` is the decision (1 refresh, 0 skip); a full
    step takes ``last_full_step`` to ``step`` and (score and token level)
    clears ``cold``; ``n_recomputed`` is the MIXED step's masked count at the
    KV level (the token budget at the token level's TOPK).  The step itself
    is advanced by the caller."""
    if level == "score":
        full, mixed, cached = mode == 1, mode == 2, mode == 0
    elif level == "token":
        full, mixed, cached = mode == TOKEN_FULL, mode == TOKEN_TOPK, mode == TOKEN_SKIP
    else:
        full, mixed, cached = mode == MODE_FULL, mode == MODE_MIXED, mode == MODE_CACHED
    n = full * max_len + (0 if n_recomputed is None else mixed * n_recomputed)
    cold = state.cold if level == "kv" else state.cold * (full == 0)
    return state.replace(
        last_full_step=state.last_full_step + full * (state.step - state.last_full_step),
        cold=cold,
        recompute_count=state.recompute_count + n,
        cache_hit_count=state.cache_hit_count + max_len - n,
        full_steps=state.full_steps + full,
        mixed_steps=state.mixed_steps + mixed,
        cached_steps=state.cached_steps + cached,
    )


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
    measured: Union[bool, torch.Tensor],
    realized: torch.Tensor,
    predicted: torch.Tensor,
    abs_target: torch.Tensor,
) -> CacheState:
    """Fold one closed skip span's realized-vs-predicted error into the guard
    telemetry (no-op unless ``measured``).  ``overrun`` is a monotone
    high-water mark of the worse of realized/predicted and
    realized/abs_target, clipped to [0, 10].  ``measured`` is a bool or a
    bool 0-d tensor; the update is masked on the device, so a measurement
    decided there (the token level) needs no host read."""
    dt = state.realized_err_sum.dtype
    if not isinstance(measured, torch.Tensor):
        if not measured:
            return state
        # A fill, not a copy from the host (which a graph capture refuses).
        measured = torch.ones((), dtype=torch.bool, device=state.overrun.device)
    ratio = realized / torch.clamp(predicted, min=GUARD_PREDICTED_FLOOR)
    miscal = torch.clamp(
        torch.maximum(ratio, realized / torch.clamp(abs_target, min=1e-3)), 0.0, 10.0
    ).to(dt)
    m = measured.to(dt)
    return state.replace(
        realized_err_sum=state.realized_err_sum + m * realized.to(dt),
        predicted_err_sum=state.predicted_err_sum + m * predicted.to(dt),
        realized_err_max=torch.maximum(state.realized_err_max, m * realized.to(dt)),
        guard_measurements=state.guard_measurements + measured.to(torch.int32),
        overrun=torch.where(measured, torch.maximum(state.overrun, miscal), state.overrun),
    )


# ----------------------------------------------------------------- updates
def update_after_forward(
    cfg: E2CRFConfig,
    state: CacheState,
    mode,
    n_masked,
    kv_new: tuple[torch.Tensor, torch.Tensor],
    crf: torch.Tensor,
    timestep: Optional[torch.Tensor] = None,
) -> CacheState:
    """Bookkeeping after a KV-level forward: the per-token CRF drift (L2 over
    d_model, mean over layers), the K/V store, the CRF and the counters;
    ``n_masked`` is the number of tokens MODE_MIXED recomputed.  With
    ``use_freqca``, every ``freq_decomp_interval`` global steps the CRF's
    low and high parts at ``timestep`` go into the history ring (shifted
    left, ``hist_len`` capped at ``max_history``); the ring is decided on the
    host here (one read), on the device in a chain."""
    check_level(cfg)
    ring = bool(kv_ring_due(cfg, state, crf.device))
    state = kv_state_update(cfg, state, kv_new, crf, timestep, ring)
    return count_mode(state, "kv", mode, crf.shape[1], n_masked)


def kv_state_update(
    cfg: E2CRFConfig,
    state: CacheState,
    kv_new: tuple[torch.Tensor, torch.Tensor],
    crf: torch.Tensor,
    timestep: Optional[torch.Tensor],
    ring: bool,
) -> CacheState:
    """The tensors of :func:`update_after_forward`: drift, store, CRF and
    (``ring``) FreqCa's ring."""
    delta = torch.linalg.vector_norm((crf - state.crf_prev).to(state.delta_tok.dtype), dim=-1)
    freqca = kv_ring_entry(cfg, state, crf, timestep) if ring else {}
    return state.replace(
        k=kv_new[0], v=kv_new[1], crf_prev=crf, delta_tok=torch.mean(delta, dim=0), **freqca
    )


RING_FIELDS = ("crf_low", "crf_high_hist", "crf_t_hist", "hist_len")


def kv_ring_entry(cfg: E2CRFConfig, state: CacheState, crf: torch.Tensor,
                  timestep: torch.Tensor) -> dict[str, torch.Tensor]:
    """FreqCa's ring (:data:`RING_FIELDS`) after adding the CRF's low and
    high parts at ``timestep``: shifted left, ``hist_len`` capped at
    ``max_history``."""
    crf_low, crf_high = frequency_decompose_fft(
        crf.reshape(-1, *crf.shape[-2:]).float(), cfg.low_freq_ratio
    )
    hist = state.crf_high_hist
    return dict(
        crf_low=crf_low.reshape(crf.shape).to(state.crf_low.dtype),
        crf_high_hist=torch.cat([hist[1:], crf_high.reshape(1, *crf.shape).to(hist.dtype)]),
        crf_t_hist=torch.cat(
            [state.crf_t_hist[1:], timestep.reshape(1).to(state.crf_t_hist.dtype)]
        ),
        hist_len=torch.clamp(state.hist_len + 1, max=cfg.max_history),
    )


def compute_event_intensity(cfg: E2CRFConfig, state: CacheState, crf: torch.Tensor) -> torch.Tensor:
    """Mean CRF-delta energy normalized by τ₀, capped at 1."""
    avg_energy = torch.mean(torch.linalg.vector_norm(crf - state.crf_prev, dim=-1))
    return torch.clamp(avg_energy / cfg.tau_0, max=1.0)


def predict_crf_freqca(cfg: E2CRFConfig, state: CacheState, t_val: torch.Tensor) -> torch.Tensor:
    """FreqCa prediction of the CRF at ``t_val``: the newest low-frequency
    part plus the Hermite-extrapolated high-frequency part over the ring's
    live entries; the previous CRF while fewer than two are live.  The JAX
    sampler never calls it (quirk Q1)."""
    k = state.crf_high_hist.shape[0]
    valid = torch.arange(k, device=state.hist_len.device) >= k - state.hist_len
    high = predict_hermite(state.crf_high_hist, state.crf_t_hist, t_val, cfg.hermite_order,
                           valid=valid)
    return torch.where(state.hist_len >= 2, state.crf_low + high, state.crf_prev)


def stat_tensor(state: CacheState) -> torch.Tensor:
    """The device values :func:`cache_stats` reads, as one float64 vector."""
    ref, cold = state.eps_norm_ref, state.eps_norm_cold
    growth = torch.where(cold > 0, ref / torch.clamp(cold, min=1e-6), 0.0)
    return torch.stack([_on(v, ref.device).double() for v in (
        state.guard_measurements, state.realized_err_sum, state.predicted_err_sum,
        state.realized_err_max, state.overrun, ref.max(), growth.max())])


def cache_stats(state: CacheState, values: Optional[list] = None,
                batch_shards: int = 1) -> dict[str, Any]:
    """Summary statistics; the same keys as the JAX package's.  One device
    read (:func:`stat_tensor`), unless ``values`` holds what it reads.
    ``batch_shards``: the state holds one rank's rows of a batch sharded
    that many ways (a mesh's data axis)."""
    if values is None:
        values = stat_tensor(state).tolist()
    n_guard, realized_sum, predicted_sum, realized_max, overrun, peak, growth = values
    n_guard = int(n_guard)
    recompute = state.recompute_count
    hits = state.cache_hit_count
    total = recompute + hits
    total_steps = state.full_steps + state.mixed_steps + state.cached_steps
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
        "realized_err_max": realized_max,
        "budget_overrun_ratio": (
            realized_sum / max(predicted_sum, n_guard * GUARD_PREDICTED_FLOOR)
            if n_guard
            else 0.0
        ),
        "overrun_mark": overrun,
        "eps_norm_peak": peak,
        "eps_norm_scale": _eps_norm_scale(state, peak, batch_shards),
        "eps_norm_growth": growth,
    }


def _eps_norm_scale(state: CacheState, peak: float, batch_shards: int = 1) -> float:
    """Peak refresh-time ε̂ norm relative to the unit-noise expectation: the
    score level norms the whole (B, T, C) ε̂, the token level each token over
    (B, C)."""
    numel = state.eps_hat.numel() * batch_shards
    if numel == 0 or peak == 0.0:
        return 0.0
    if state.eps_norm_ref.ndim == 1:
        numel //= state.eps_norm_ref.shape[0]
    return peak / float(numel) ** 0.5
