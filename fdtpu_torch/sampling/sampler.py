"""Reverse-diffusion sampling (port of ``fdtpu/sampling/sampler.py:99-635,
784-1151``).

The JAX package compiles the whole trajectory into one ``lax.scan``; here the
reverse Euler–Maruyama chain is a Python loop over steps, and each step's
branch of the E²-CRF cache is decided on the host from the float32 cache
state (at most one device read a step):

* score level: run the network (refresh) or rebuild the score from the
  extrapolated ε̂ (skip);
* token level: FULL (the cached forward in MODE_FULL), TOPK (the
  ``token_budget`` highest-priority tokens through the network, the rest
  extrapolated) or SKIP;
* KV level: the cached forward in the mode of the macro or event policy.

The score level's skip predictor is a Taylor extrapolation of ε̂
(``eps_order``) or FreqCa (``eps_predictor="freqca"``: the low-frequency part
of the last refresh plus a Hermite extrapolation of the high-frequency parts
of the last ``max_history`` refreshes); the KV level keeps FreqCa's CRF
history with ``use_freqca``.  FreSca (``use_fresca``) rescales each step's
score by frequency band, at every level, after the cache has taken what it
keeps.  Neither reads the device: a skip step's one read stays the skip
decision.

The token and KV levels update the cache's K/V store in place (the JAX
package returns a new one); a state handed to ``sample_chain`` is updated.

Noise can be injected: ``sample_chain`` takes ``step_noise`` of shape
``(num_steps, B, T, C)`` and ``probe_noise`` ``(num_steps, T)`` (the uniforms
of the random probes, token and KV levels), and ``DiffusionSampler.sample``
takes ``prior_noise`` ``(N, T, C)``, ``step_noise`` ``(num_steps, N, T, C)``
and ``probe_noise`` ``(num_batches, num_steps, T)``; otherwise the noise is
drawn from a ``torch.Generator``.  JAX and torch random streams never match,
so replaying a JAX chain means handing its draws in.

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
    MODE_FULL,
    TOKEN_FULL,
    TOKEN_TOPK,
    CacheState,
    E2CRFConfig,
    PolicyParams,
    cache_stats,
    check_level,
    event_policy,
    guard_relative_error,
    init_cache_state,
    macro_policy,
    record_guard_measurement,
    score_skip_decision,
    token_policy,
    update_after_forward,
)
from fdtpu_torch.diffusion.sde import SDE
from fdtpu_torch.models.score_models import (
    ScoreModel,
    ScoreNetwork,
    score_apply_cached,
    score_apply_topk,
)
from fdtpu_torch.ops.fourier import frequency_decompose_fft, predict_hermite
from fdtpu_torch.ops.fresca import apply_fresca_to_score
from fdtpu_torch.utils.device import module_device


def _check_cache_config(cfg: E2CRFConfig) -> None:
    if cfg.eps_predictor not in ("taylor", "freqca"):
        raise ValueError(f"eps_predictor must be 'taylor' or 'freqca' (got {cfg.eps_predictor!r})")
    if cfg.eps_predictor == "freqca" and cfg.level != "score":
        raise ValueError(
            f"eps_predictor='freqca' is a score-level predictor (got level={cfg.level!r})"
        )
    check_level(cfg)


def _prep_cache_for_new_batch(state: CacheState) -> CacheState:
    """Cross-batch cache prep (quirk Q5): keep the store but mark it cold so
    the new trajectory recomputes and re-calibrates its drift rate."""
    return state.replace(cold=True, drift_rate=torch.zeros_like(state.drift_rate))


def eps_predict(
    c: CacheState, steps_ahead: float, cfg: E2CRFConfig, t: torch.Tensor
) -> torch.Tensor:
    """Extrapolate ε̂ ``steps_ahead`` past the last full computation, to the
    step at time ``t``.

    ``eps_predictor="taylor"``: order (``eps_order``) 0 frozen reuse, 1 linear
    from the last two full computations, 2 quadratic (Newton form) from the
    last three.  ``"freqca"``: the last refresh's low-frequency part plus the
    Hermite-extrapolated high-frequency part over the refresh ring, at the
    true ``t``; the fit is extrapolated only once it is determined (more live
    entries than ``hermite_order``), and below two live entries ε̂ is reused.
    """
    if cfg.eps_predictor == "freqca":
        k_hist = c.crf_high_hist.shape[0]
        valid = torch.arange(k_hist, device=c.hist_len.device) >= k_hist - c.hist_len
        high = predict_hermite(c.crf_high_hist, c.crf_t_hist, t, order=cfg.hermite_order,
                               valid=valid, clip_target=c.hist_len <= cfg.hermite_order)
        pred = c.crf_low.to(c.eps_hat.dtype) + high.to(c.eps_hat.dtype)
        return torch.where(c.hist_len >= 2, pred, c.eps_hat)
    order = cfg.eps_order
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


def _refresh(network, c: CacheState, cfg: E2CRFConfig, pp: PolicyParams, x, t, t_batch, std):
    """Full step: run the network, measure the drift against what a skip
    would have predicted, and roll the ε̂ history (and FreqCa's ring)."""
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
        eps_pred = eps_predict(c, float(steps_since), cfg, t)
        rel = guard_relative_error(torch.linalg.vector_norm(eps_new - eps_pred), denom, norm_ref)
        drift_rate = rel / steps_since
    measured = (not c.cold) and steps_since > 1
    trace = (float(measured), rel, denom, c.err_acc, float(steps_since))
    # A refresh that closes a real skip span measures the realized error
    # against what the budget predicted (err_acc).
    c = record_guard_measurement(c, measured, rel, c.err_acc, pp.guard_abs_tol)
    cold = c.cold
    freqca = {}
    if cfg.eps_predictor == "freqca":
        eps_low, eps_high = frequency_decompose_fft(eps_new, cfg.low_freq_ratio)
        hist = c.crf_high_hist
        freqca = dict(
            crf_low=eps_low.to(c.crf_low.dtype),
            crf_high_hist=torch.cat([hist[1:], eps_high[None].to(hist.dtype)]),
            crf_t_hist=torch.cat([c.crf_t_hist[1:], t.reshape(1).to(c.crf_t_hist.dtype)]),
            # A cold refresh starts a new trajectory: the ring's older
            # entries belong to the previous one.
            hist_len=(torch.ones_like(c.hist_len) if cold
                      else torch.clamp(c.hist_len + 1, max=hist.shape[0])),
        )
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
        **freqca,
    )
    return score, c, trace


def _skip(c: CacheState, cfg: E2CRFConfig, t, std, max_len: int):
    """Skipped step: rebuild the score from the predicted noise."""
    eps = eps_predict(c, float(c.step - c.last_full_step + 1), cfg, t)
    score = -eps / std[..., None]
    c = c.replace(
        err_acc=c.err_acc + c.drift_rate,
        cached_steps=c.cached_steps + 1,
        cache_hit_count=c.cache_hit_count + max_len,
    )
    return score, c


def _tok_norms(eps: torch.Tensor) -> torch.Tensor:
    """Per-token norms over (batch, channels), float32."""
    return torch.linalg.vector_norm(eps.float(), dim=(0, 2))


def _tok_residual_rate(eps_new, pred, ages, ref) -> torch.Tensor:
    """Relative extrapolation residual per token per elapsed step: norms over
    (batch, channels) in float32, ``ages`` the steps the prediction bridged,
    ``ref`` each token's trajectory-scale ε̂ norm (the denominator floor)."""
    num = torch.linalg.vector_norm((eps_new - pred).float(), dim=(0, 2))
    rel = guard_relative_error(num, _tok_norms(eps_new) + 1e-8, ref.float())
    return rel / torch.clamp(ages.float(), min=1.0)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median of a vector, the mean of the two middle values when the count
    is even (``jnp.median``; ``torch.median`` returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _topk_rows(priority: torch.Tensor, budget: int) -> torch.Tensor:
    """The ``budget`` largest entries' indices, lower index first among ties
    (``jax.lax.top_k``'s order; ``torch.topk`` does not keep it, and the
    probe and anchor bonuses make ties routine).  Every entry gets a unique
    int64 key, the float32 priority's order-preserving bit image times n
    plus its reversed index, so no tie is left to the device's sort."""
    n = priority.shape[0]
    bits = priority.float().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    rank = torch.arange(n - 1, -1, -1, device=priority.device)
    return torch.topk(key * n + rank, budget).indices


def _token_step(network, c: CacheState, cfg: E2CRFConfig, pp: PolicyParams, x, t_batch, std,
                low_bonus, probe):
    """One step of the token level (``token_level_body``): FULL, TOPK or SKIP.
    ``probe()`` gives the step's (T,) probe uniforms, drawn only at TOPK."""
    max_len = x.shape[1]
    stdc = std[..., None]
    budget = min(int(cfg.token_budget), max_len)
    # Per-token linear extrapolation of ε̂ (order 0: frozen reuse).
    age = (c.step - c.last_tok).to(x.dtype)  # (T,)
    eps_pred = c.eps_hat
    if cfg.eps_order != 0:
        gap = c.gap_tok[None, :, None]
        slope = torch.where(gap > 0, (c.eps_hat - c.eps_prev) / torch.clamp(gap, min=1.0), 0.0)
        eps_pred = c.eps_hat + slope * age[None, :, None]
    mode, w_drift, mean_drift = token_policy(cfg, pp, c, x)

    if mode == TOKEN_FULL:
        score, kv, _ = score_apply_cached(network, x, t_batch, (c.k, c.v), None, MODE_FULL)
        eps_new = -stdc * score
        tok_norms = _tok_norms(eps_new).to(c.eps_norm_ref.dtype)
        norm_ref = torch.maximum(c.eps_norm_ref, tok_norms)
        if c.cold:
            rate = torch.zeros((max_len,), dtype=c.delta_tok.dtype, device=x.device)
        else:
            rate = _tok_residual_rate(eps_new, eps_pred, age, norm_ref).to(c.delta_tok.dtype)
            # Realized mean per-token error over the spans just closed (rate ×
            # age undoes the per-step normalization) against the budget.
            realized = torch.mean(rate.float() * torch.clamp(age, min=1.0))
            c = record_guard_measurement(c, torch.max(age) > 1, realized, c.err_acc,
                                         pp.guard_abs_tol)
        c = c.replace(
            k=kv[0],
            v=kv[1],
            eps_prev=eps_new if c.cold else c.eps_hat,
            gap_tok=torch.zeros_like(age) if c.cold else age,
            eps_hat=eps_new,
            last_tok=torch.full_like(c.last_tok, c.step),
            delta_tok=rate,
            eps_norm_ref=norm_ref,
            eps_norm_cold=tok_norms if c.cold else c.eps_norm_cold,
            err_acc=torch.zeros_like(c.err_acc),
            last_full_step=c.step,
            cold=False,
            full_steps=c.full_steps + 1,
            recompute_count=c.recompute_count + max_len,
        )
        return score, c

    if mode == TOKEN_TOPK:
        # Priority: each token's accumulated predicted error (drift rate ×
        # steps since its last recompute, energy-weighted), the K lowest
        # frequencies always in, random probes forced in below them.
        acc_err = w_drift * (age + 1.0)
        probe_bonus = torch.where(probe() < pp.random_probe_ratio, 1e9, 0.0)
        idx = _topk_rows(acc_err + low_bonus + probe_bonus, budget)
        out_rows, kv = score_apply_topk(network, x, t_batch, (c.k, c.v), idx)
        eps_rows = -std.index_select(1, idx)[..., None] * out_rows
        age_rows = age.index_select(0, idx)
        ref_rows = torch.maximum(c.eps_norm_ref.index_select(0, idx),
                                 _tok_norms(eps_rows).to(c.eps_norm_ref.dtype))
        rate_rows = _tok_residual_rate(
            eps_rows, eps_pred.index_select(1, idx), age_rows, ref_rows
        ).to(c.delta_tok.dtype)
        # Guard telemetry of the audited rows: the MEDIAN of their realized
        # errors (one ancient diverged row must not read as a collapse).
        if not c.cold:
            realized = _median(rate_rows.float() * torch.clamp(age_rows.float(), min=1.0))
            c = record_guard_measurement(c, torch.max(age_rows) > 1, realized, c.err_acc,
                                         pp.guard_abs_tol)
        score = -eps_pred.index_copy(1, idx, eps_rows) / stdc
        # Unattended drift accrues into the error budget.
        attended = torch.sum(w_drift.index_select(0, idx)) / max_len
        err_inc = torch.clamp(mean_drift - attended, min=0.0)
        c = c.replace(
            k=kv[0],
            v=kv[1],
            # eps_prev takes the rows of eps_hat before eps_hat takes the new ones.
            eps_prev=c.eps_prev.index_copy(1, idx, c.eps_hat.index_select(1, idx)),
            gap_tok=c.gap_tok.index_copy(0, idx, age_rows),
            eps_hat=c.eps_hat.index_copy(1, idx, eps_rows),
            last_tok=c.last_tok.index_fill(0, idx, c.step),
            delta_tok=c.delta_tok.index_copy(0, idx, rate_rows),
            eps_norm_ref=c.eps_norm_ref.index_copy(0, idx, ref_rows),
            err_acc=c.err_acc + err_inc.to(c.err_acc.dtype),
            mixed_steps=c.mixed_steps + 1,
            recompute_count=c.recompute_count + budget,
            cache_hit_count=c.cache_hit_count + (max_len - budget),
        )
        return score, c

    c = c.replace(
        err_acc=c.err_acc + mean_drift.to(c.err_acc.dtype),
        cached_steps=c.cached_steps + 1,
        cache_hit_count=c.cache_hit_count + max_len,
    )
    return -eps_pred / stdc, c


def _kv_step(network, c: CacheState, cfg: E2CRFConfig, pp: PolicyParams, x, t, t_batch, probe):
    """One step of the KV level (``kv_level_body``): the policy's mode, the
    cached forward in it, the bookkeeping."""
    if cfg.policy == "macro":
        mode, mask, n_masked = macro_policy(pp, c, x.shape[1], x.device)
    else:
        probe_u = probe() if cfg.resolved_random_probe_ratio > 0.0 else None
        mode, mask, n_masked = event_policy(cfg, pp, c, x, probe_u)
    score, kv, crf = score_apply_cached(network, x, t_batch, (c.k, c.v), mask, mode)
    return score, update_after_forward(cfg, c, mode, n_masked, kv, crf, t)


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
    probe_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    use_fresca: bool = False,
    fresca_low_scale: float = 1.0,
    fresca_high_scale: float = 1.5,
    fresca_cutoff_ratio: float = 0.5,
    fresca_cutoff_strategy: str = "energy",
    guard_trace: bool = False,
):
    """Run the reverse diffusion from the prior sample ``x0``.

    Returns ``(x, cache_state)``; with ``guard_trace=True`` (score level)
    also per-step telemetry ``(measured, rel, eps_norm, err_acc,
    steps_since)``, each ``(num_steps,)`` and zero on skipped steps, laid out
    as the JAX package's ``guard_trace``.  A token- or KV-level
    ``cache_state`` passed in has its K/V store updated in place.  With
    ``use_fresca`` each step's score goes through ``apply_fresca_to_score``
    (the ``fresca_*`` arguments, the JAX defaults) before the update of x.
    """
    if cache_cfg is not None:
        _check_cache_config(cache_cfg)
    if guard_trace and (cache_cfg is None or cache_cfg.level != "score"):
        raise NotImplementedError("guard_trace only supports level='score'")
    network = network.compute_copy()
    ts, step_size = scheduler.timesteps(num_steps, device=x0.device)
    batch = x0.shape[0]

    def noise(i: int, x: torch.Tensor) -> torch.Tensor:
        if step_noise is not None:
            return step_noise[i].to(device=x.device, dtype=x.dtype)
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    def fresca(score: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if not use_fresca:
            return score
        return apply_fresca_to_score(
            score, fresca_low_scale, fresca_high_scale, fresca_cutoff_ratio,
            fresca_cutoff_strategy, timestep=t, num_steps=num_steps,
        )

    x = x0
    if cache_cfg is None:
        for i in range(num_steps):
            t = ts[i]
            score = fresca(network(x, t.expand(batch)), t)
            x = scheduler.step(score, t, x, noise(i, x), step_size)
        return x, None

    pp = cache_cfg.policy_params(x0.device)
    level = cache_cfg.level
    max_len = x0.shape[1]
    cache = cache_state
    if cache is None:
        cfg = network.config
        cache = init_cache_state(
            cache_cfg, batch, max_len, x0.shape[2], x0.device, num_layers=cfg.num_layers,
            n_head=cfg.n_head, head_dim=cfg.head_dim, d_model=cfg.d_model, kv_dtype=cfg._cdtype,
        )
    skipped = (0.0, torch.zeros((), device=x.device), torch.zeros((), device=x.device),
               torch.zeros((), device=x.device), 0.0)
    # The token level's K low-frequency anchors, ahead of every other token.
    low_bonus = torch.where(torch.arange(max_len, device=x.device) < pp.K, 2e9, 0.0)
    traces = []
    for i in range(num_steps):
        t = ts[i]
        t_batch = t.expand(batch)

        def probe() -> torch.Tensor:
            if probe_noise is not None:
                return probe_noise[i].to(device=x.device, dtype=torch.float32)
            return torch.rand((max_len,), generator=generator, device=x.device)

        if level == "kv":
            score, cache = _kv_step(network, cache, cache_cfg, pp, x, t, t_batch, probe)
        else:
            _, std = scheduler.marginal_prob(x, t_batch)
            if level == "token":
                score, cache = _token_step(network, cache, cache_cfg, pp, x, t_batch, std,
                                           low_bonus, probe)
            elif score_skip_decision(cache_cfg, pp, cache):
                score, cache, trace = _refresh(network, cache, cache_cfg, pp, x, t, t_batch, std)
            else:
                score, cache = _skip(cache, cache_cfg, t, std, max_len)
                trace = skipped
        if guard_trace:
            traces.append(trace)
        x = scheduler.step(fresca(score, t), t, x, noise(i, x), step_size)
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

    ``cache_kwargs`` takes the fields of :class:`E2CRFConfig`, FreqCa's
    included (``eps_predictor="freqca"`` at the score level, ``use_freqca``
    at the KV level); ``use_fresca`` and the ``fresca_*`` arguments scale each
    step's score by frequency band, with the JAX package's defaults.  Not
    ported yet (ROADMAP.md): ``mesh`` and ``batches_per_call > 1``.
    """

    def __init__(
        self,
        score_model: ScoreModel,
        sample_batch_size: int,
        use_cache: bool = False,
        cache_kwargs: Optional[dict] = None,
        use_fresca: bool = False,
        fresca_low_scale: float = 1.0,
        fresca_high_scale: float = 1.5,
        fresca_cutoff_ratio: float = 0.5,
        fresca_cutoff_strategy: str = "energy",
        mesh: Optional[Any] = None,
        batches_per_call: int = 1,
    ) -> None:
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
        cfg = self.cache_config
        if cfg is not None:
            _check_cache_config(cfg)
            self._check_level_settings(cfg)
        self.last_cache_state: Optional[CacheState] = None
        self.use_fresca = use_fresca
        self.fresca_low_scale = fresca_low_scale
        self.fresca_high_scale = fresca_high_scale
        self.fresca_cutoff_ratio = fresca_cutoff_ratio
        self.fresca_cutoff_strategy = fresca_cutoff_strategy

    def _check_level_settings(self, cfg: E2CRFConfig) -> None:
        """The JAX sampler's checks of the token and KV settings: a token
        budget in [1, max_len]; warnings for unaudited stale rows (token level
        without probes) and for a KV event threshold that caches nothing."""
        if cfg.level == "token" and not 1 <= cfg.token_budget <= self.max_len:
            raise ValueError(
                "level='token' needs 1 <= token_budget <= max_len "
                f"(got {cfg.token_budget}, max_len {self.max_len})"
            )
        if cfg.level == "token" and cfg.random_probe_ratio == 0.0 and cfg.guard != "off":
            warnings.warn(
                "level='token' with random_probe_ratio=0.0: stale rows the "
                "top-k never selects go unaudited, so cumulative collapse "
                "there is invisible to the error-budget guard. Leave "
                "random_probe_ratio unset to get the 0.02 default, or set "
                "guard='off' to silence this warning.",
                stacklevel=3,
            )
        if cfg.level == "kv" and cfg.policy == "event" and cfg.tau_0 < 1.0:
            warnings.warn(
                f"level='kv' with policy='event' and tau_0={cfg.tau_0} < 1: the "
                "KV-level CRF drift is unnormalized, so this threshold triggers "
                "recomputation every step (no caching). Calibrated values are "
                "tau_0 in [1, 1000]; see cli/ablation_cache.py.",
                stacklevel=3,
            )

    def _init_cache(self, batch_size: int) -> Optional[CacheState]:
        if not self.use_cache:
            return None
        cfg = self.score_model.config
        return init_cache_state(
            self.cache_config, batch_size, self.max_len, self.n_channels, self.device,
            num_layers=cfg.num_layers, n_head=cfg.n_head, head_dim=cfg.head_dim,
            d_model=cfg.d_model, kv_dtype=cfg._cdtype,
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
        probe_noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Generate ``num_samples`` series ``(N, T, C)`` on the model's device.

        Remainder-dropping batch count (quirk Q6) and cache persistence
        across batches (quirk Q5).  Noise comes from ``prior_noise`` /
        ``step_noise`` (indexed by sample) and ``probe_noise`` (indexed by
        batch) when given, else from ``generator`` (seed 0 on the model's
        device by default)."""
        if num_diffusion_steps is None:
            num_diffusion_steps = self.score_model.num_training_steps
        if generator is None and any(a is None for a in (prior_noise, step_noise, probe_noise)):
            generator = torch.Generator(device=self.device).manual_seed(0)

        num_batches = max(1, num_samples // self.sample_batch_size)
        all_samples = []
        cache_state: Optional[CacheState] = None

        def cache_batch(state: CacheState) -> int:
            # Batch size of whichever per-batch store this level allocates.
            return state.k.shape[1] if state.k.ndim > 1 else state.eps_hat.shape[0]

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
                or cache_batch(cache_state) != batch_size
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
                probe_noise=None if probe_noise is None else probe_noise[batch_idx],
                generator=generator,
                use_fresca=self.use_fresca,
                fresca_low_scale=self.fresca_low_scale,
                fresca_high_scale=self.fresca_high_scale,
                fresca_cutoff_ratio=self.fresca_cutoff_ratio,
                fresca_cutoff_strategy=self.fresca_cutoff_strategy,
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
