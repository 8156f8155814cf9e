"""Reverse-diffusion sampling (port of ``fdtpu/sampling/sampler.py:99-635,
784-1151``).

The JAX package compiles the whole trajectory into one ``lax.scan``.  Here a
trajectory is a :class:`~fdtpu_torch.sampling.resident.Chain`, which runs
the one step table of :mod:`fdtpu_torch.sampling.resident`: each step's
decision of the E²-CRF cache, taken on the device from the float32 cache
state and the device counters, picks one of the step's branches:

* score level: run the network (refresh) or rebuild the score from the
  extrapolated ε̂ (skip);
* token level: FULL (the cached forward in MODE_FULL), TOPK (the
  ``token_budget`` highest-priority tokens through the network, the rest
  extrapolated) or SKIP;
* KV level: the cached forward in the mode of the macro or event policy.

This module holds the branches' arithmetic (:func:`_refresh`,
:func:`_skip`, :func:`_token_mode_step`), :func:`sample_chain` (one
trajectory from a given prior sample, the eager loop: a device read a
step) and :class:`DiffusionSampler`, whose :meth:`~DiffusionSampler.sample`
runs its batches through one cached chain, eagerly or, with
``batches_per_call > 1``, as replays of a graph with the branches taken on
the device.

The score level's skip predictor is a Taylor extrapolation of ε̂
(``eps_order``) or FreqCa (``eps_predictor="freqca"``: the low-frequency part
of the last refresh plus a Hermite extrapolation of the high-frequency parts
of the last ``max_history`` refreshes); the KV level keeps FreqCa's CRF
history with ``use_freqca``.  FreSca (``use_fresca``) rescales each step's
score by frequency band, at every level, after the cache has taken what it
keeps.  Neither reads the device.

Noise can be injected: ``sample_chain`` takes ``step_noise`` of shape
``(num_steps, B, T, C)`` and ``probe_noise`` ``(num_steps, T)`` (the uniforms
of the random probes, token and KV levels), and ``DiffusionSampler.sample``
takes ``prior_noise`` ``(N, T, C)``, ``step_noise`` ``(num_steps, N, T, C)``
and ``probe_noise`` ``(num_batches, num_steps, T)``; otherwise the noise is
drawn from a ``torch.Generator``: a batch draws its prior, then each step
its probe uniforms (token level every step, used at TOPK; KV event level
with probes), then its noise.  JAX and torch random streams never match, so
replaying a JAX chain means handing its draws in.

Reference parity kept on purpose: remainder-dropping batch count (quirk Q6)
and cache persistence across batches with a global step counter, the cache
marked cold for each new trajectory (quirk Q5, opt-out
``reset_between_batches``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional, Union

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
    guard_relative_error,
    init_cache_state,
    record_guard_measurement,
)
from fdtpu_torch.diffusion.sde import SDE
from fdtpu_torch.dist.parallel import Axis, Group, ShardedGenerator, batch_norm, gather_batch
from fdtpu_torch.models.score_models import (
    ScoreModel,
    ScoreNetwork,
    score_apply_cached,
    score_apply_topk,
)
from fdtpu_torch.ops.fourier import frequency_decompose_fft, predict_hermite
from fdtpu_torch.ops.fresca import apply_fresca_to_score
from fdtpu_torch.utils.device import module_device
from fdtpu_torch.utils.profiling import span


def _check_cache_config(cfg: E2CRFConfig) -> None:
    if cfg.eps_predictor not in ("taylor", "freqca"):
        raise ValueError(f"eps_predictor must be 'taylor' or 'freqca' (got {cfg.eps_predictor!r})")
    if cfg.eps_predictor == "freqca" and cfg.level != "score":
        raise ValueError(
            f"eps_predictor='freqca' is a score-level predictor (got level={cfg.level!r})"
        )
    check_level(cfg)


def eps_predict(
    c: CacheState, steps_ahead: Union[float, torch.Tensor], cfg: E2CRFConfig, t: torch.Tensor
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


def _since(c: CacheState, since: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """``step − last_full_step``: ``since`` (a chain's 0-d device value) or
    the state's counters, as a fill (no copy from the host)."""
    if since is not None:
        return since
    return torch.full((), c.step - c.last_full_step, dtype=torch.int64, device=like.device)


def _refresh(network, c: CacheState, cfg: E2CRFConfig, pp: PolicyParams, x, t, t_batch, std,
             since: Optional[torch.Tensor] = None, group: Group = None):
    """Full step: run the network, measure the drift against what a skip
    would have predicted, and roll the ε̂ history (and FreqCa's ring).
    ``since`` as in :func:`_since`; ``x`` may be one rank's rows, ``group``
    holding the others (:mod:`fdtpu_torch.dist.parallel`).  The step counters
    are left to the chain (:func:`~fdtpu_torch.cache.e2crf.count_mode`)."""
    score = network(x, t_batch)
    eps_new = -std[..., None] * score
    denom = batch_norm(eps_new, group=group) + 1e-8
    # Trajectory noise scale: high-water mark of the refresh-time ‖ε̂‖.
    norm_ref = torch.maximum(c.eps_norm_ref, denom.to(x.dtype))
    zero = torch.zeros_like(c.eps_gap)
    # A device value, so that the division below is the JAX package's
    # (CUDA divides by a host scalar through its reciprocal).
    steps_since = torch.clamp(_since(c, since, x), min=1).to(zero.dtype)
    if c.cold:
        rel = drift_rate = zero
    else:
        # The denominator is floored at 10% of the trajectory scale.
        eps_pred = eps_predict(c, steps_since, cfg, t)
        rel = guard_relative_error(batch_norm(eps_new - eps_pred, group=group), denom, norm_ref)
        drift_rate = rel / steps_since
    measured = (not c.cold) and steps_since > 1
    trace = (measured, rel, denom, c.err_acc, steps_since)
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
        eps_prev2=eps_new if cold else c.eps_prev,
        eps_gap2=zero if cold else c.eps_gap,
        eps_prev=eps_new if cold else c.eps_hat,
        eps_gap=zero if cold else steps_since,
        eps_hat=eps_new,
        drift_rate=drift_rate,
        err_acc=zero,
        **freqca,
    )
    return score, c, trace


def _skip(c: CacheState, cfg: E2CRFConfig, t, std, since: Optional[torch.Tensor] = None):
    """Skipped step: rebuild the score from the predicted noise (``since``
    as in :func:`_since`)."""
    eps = eps_predict(c, (_since(c, since, std) + 1).to(c.eps_gap.dtype), cfg, t)
    score = -eps / std[..., None]
    return score, c.replace(err_acc=c.err_acc + c.drift_rate)


def _filled(like: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``like``-shaped tensor of the 0-d device tensor ``value``, without a
    read to the host (a captured graph reads its step counters on the
    device; ``full_like`` and ``index_fill`` would read the value)."""
    return torch.zeros_like(like) + value.to(like.dtype)


def _tok_norms(eps: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Per-token norms over (batch, channels), float32."""
    return batch_norm(eps.float(), (0, 2), group)


def _tok_residual_rate(eps_new, pred, ages, ref, group: Group = None) -> torch.Tensor:
    """Relative extrapolation residual per token per elapsed step: norms over
    (batch, channels) in float32, ``ages`` the steps the prediction bridged,
    ``ref`` each token's trajectory-scale ε̂ norm (the denominator floor)."""
    num = batch_norm((eps_new - pred).float(), (0, 2), group)
    rel = guard_relative_error(num, _tok_norms(eps_new, group) + 1e-8, ref.float())
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


def _token_mode_step(network, c: CacheState, cfg: E2CRFConfig, pp: PolicyParams, x, t_batch,
                     std, low_bonus, probe_u, mode, w_drift, mean_drift, step,
                     group: Group = None, on_rows: Optional[Callable] = None):
    """One step of the token level (``token_level_body``) in ``mode``: FULL,
    TOPK or SKIP, with the policy's ``w_drift`` and ``mean_drift`` and the
    step's probe uniforms ``probe_u`` (T,), read at TOPK; ``step`` is the
    global step, a 0-d int64 tensor; ``group`` as in :func:`_refresh`.
    ``on_rows``, if given, is handed the TOPK step's rows (``budget``,) int64,
    highest priority first.  The counters are left to the chain."""
    max_len = x.shape[1]
    stdc = std[..., None]
    budget = min(int(cfg.token_budget), max_len)
    # Per-token linear extrapolation of ε̂ (order 0: frozen reuse).
    age = (step - c.last_tok).to(x.dtype)  # (T,)
    eps_pred = c.eps_hat
    if cfg.eps_order != 0:
        gap = c.gap_tok[None, :, None]
        slope = torch.where(gap > 0, (c.eps_hat - c.eps_prev) / torch.clamp(gap, min=1.0), 0.0)
        eps_pred = c.eps_hat + slope * age[None, :, None]

    if mode == TOKEN_FULL:
        score, kv, _ = score_apply_cached(network, x, t_batch, (c.k, c.v), None, MODE_FULL)
        eps_new = -stdc * score
        tok_norms = _tok_norms(eps_new, group).to(c.eps_norm_ref.dtype)
        norm_ref = torch.maximum(c.eps_norm_ref, tok_norms)
        if c.cold:
            rate = torch.zeros((max_len,), dtype=c.delta_tok.dtype, device=x.device)
        else:
            rate = _tok_residual_rate(eps_new, eps_pred, age, norm_ref,
                                      group).to(c.delta_tok.dtype)
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
            last_tok=_filled(c.last_tok, step),
            delta_tok=rate,
            eps_norm_ref=norm_ref,
            eps_norm_cold=tok_norms if c.cold else c.eps_norm_cold,
            err_acc=torch.zeros_like(c.err_acc),
        )
        return score, c

    if mode == TOKEN_TOPK:
        # Priority: each token's accumulated predicted error (drift rate ×
        # steps since its last recompute, energy-weighted), the K lowest
        # frequencies always in, random probes forced in below them.
        acc_err = w_drift * (age + 1.0)
        probe_bonus = torch.where(probe_u < pp.random_probe_ratio, 1e9, 0.0)
        idx = _topk_rows(acc_err + low_bonus + probe_bonus, budget)
        if on_rows is not None:
            on_rows(idx)
        out_rows, kv = score_apply_topk(network, x, t_batch, (c.k, c.v), idx)
        eps_rows = -std.index_select(1, idx)[..., None] * out_rows
        age_rows = age.index_select(0, idx)
        ref_rows = torch.maximum(c.eps_norm_ref.index_select(0, idx),
                                 _tok_norms(eps_rows, group).to(c.eps_norm_ref.dtype))
        rate_rows = _tok_residual_rate(
            eps_rows, eps_pred.index_select(1, idx), age_rows, ref_rows, group
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
            last_tok=c.last_tok.index_copy(0, idx, _filled(idx, step).to(c.last_tok.dtype)),
            delta_tok=c.delta_tok.index_copy(0, idx, rate_rows),
            eps_norm_ref=c.eps_norm_ref.index_copy(0, idx, ref_rows),
            err_acc=c.err_acc + err_inc.to(c.err_acc.dtype),
        )
        return score, c

    c = c.replace(err_acc=c.err_acc + mean_drift.to(c.err_acc.dtype))
    return -eps_pred / stdc, c


def no_fresca(score: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The step's score transform with FreSca off: the score as it is."""
    return score


def _fresca(use_fresca: bool, low_scale, high_scale, cutoff_ratio: float, cutoff_strategy: str,
            num_steps: int, group: Group = None):
    """Each step's score transform: FreSca with these settings, or
    :func:`no_fresca` (``group`` as in :func:`_refresh`)."""
    if not use_fresca:
        return no_fresca

    def fresca(score: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return apply_fresca_to_score(score, low_scale, high_scale, cutoff_ratio, cutoff_strategy,
                                     timestep=t, num_steps=num_steps, group=group)

    return fresca


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
    """Run the reverse diffusion from the prior sample ``x0``: the eager
    loop, one device read a step at the cached levels
    (:meth:`~fdtpu_torch.sampling.resident.Chain.run_eager`).

    Returns ``(x, cache_state)``; with ``guard_trace=True`` (score level)
    also per-step telemetry ``(measured, rel, eps_norm, err_acc,
    steps_since)``, each ``(num_steps,)`` and zero on skipped steps, laid out
    as the JAX package's ``guard_trace``.  ``cache_state`` is not changed: the
    chain works on copies of its tensors.  With ``use_fresca`` each step's
    score goes through ``apply_fresca_to_score`` (the ``fresca_*``
    arguments, the JAX defaults) before the update of x.
    """
    from fdtpu_torch.sampling.resident import Chain

    if cache_cfg is not None:
        _check_cache_config(cache_cfg)
    if guard_trace and (cache_cfg is None or cache_cfg.level != "score"):
        raise NotImplementedError("guard_trace only supports level='score'")
    pp = None
    if cache_cfg is not None:
        pp = cache_cfg.policy_params(x0.device)
        if cache_state is None:
            cfg = network.config
            cache_state = init_cache_state(
                cache_cfg, x0.shape[0], x0.shape[1], x0.shape[2], x0.device,
                num_layers=cfg.num_layers, n_head=cfg.n_head, head_dim=cfg.head_dim,
                d_model=cfg.d_model, kv_dtype=cfg._cdtype,
            )
    fresca = _fresca(use_fresca, fresca_low_scale, fresca_high_scale, fresca_cutoff_ratio,
                     fresca_cutoff_strategy, num_steps)
    chain = Chain(network, scheduler, cache_cfg, pp, cache_state, x0.shape[0], num_steps, fresca,
                  x0.device, resident=False, inject_steps=step_noise is not None,
                  inject_probes=probe_noise is not None, guard_trace=guard_trace)
    chain.load(x0, step_noise, probe_noise)
    chain.begin_call(generator)
    chain.run_eager()
    chain.end_call(generator)
    state, _ = chain.read()
    if guard_trace:
        return chain.x, state, tuple(chain.trace[:, j] for j in range(5))
    return chain.x, state


class DiffusionSampler:
    """User-facing sampler (the JAX package's ``DiffusionSampler``).

    ``cache_kwargs`` takes the fields of :class:`E2CRFConfig`, FreqCa's
    included (``eps_predictor="freqca"`` at the score level, ``use_freqca``
    at the KV level); ``use_fresca`` and the ``fresca_*`` arguments scale each
    step's score by frequency band, with the JAX package's defaults.

    Every call runs its batches, one trajectory each, through one chain
    (:class:`~fdtpu_torch.sampling.resident.Chain`), made at the sampler's
    first call of that batch size, step count, set of injected draws and
    way of running, and kept: the cache carried from one batch to the next
    and marked cold (quirk Q5), the first batch's fresh; the counters and
    the statistics read once, after the last batch.  ``batches_per_call`` >
    1 runs the batches as the JAX package's resident path does, when there
    is more than one batch: each trajectory is one replay of a graph
    captured at the chain's first call, its decisions taken on the device,
    the replays back to back with nothing read in between; on a CPU network
    the same functions run as a loop.  The JAX package runs a remainder of
    fewer than ``batches_per_call`` batches through its per-batch program,
    itself a whole trajectory a dispatch, because a shorter group would
    recompile its scan; here the remainder's trajectories are replays of the
    same graph.  Otherwise each trajectory runs eagerly (a device read a
    step, of the branch): the same functions, so the same values.  A chain
    holds the network as it was cast to its compute dtype when the chain
    was made.  After a call, ``last_modes`` holds each batch's mode at every
    step ((batches, steps), on the device; None uncached), and at the token
    level ``last_rows`` the rows each TOPK step took ((batches, steps,
    budget) int64 on the device, highest priority first, −1 at the other
    steps; None at other levels).

    ``mesh`` (a :class:`~torch.distributed.device_mesh.DeviceMesh` with a
    ``data`` axis, :func:`fdtpu_torch.dist.create_mesh`; every rank of it
    constructs the sampler and calls :meth:`sample` alike): each batch is
    sharded over ``data``, as the JAX package's ``_shard_cache_state`` places
    it — this rank runs its ``sample_batch_size / data`` rows, with ε̂, its
    history and FreqCa's ε̂ ring, and the K/V stores, of those rows; every
    other cache field replicated.  The batch's draws are the whole batch's,
    from the same generator on every rank in the single-device order, cut to
    the rank's rows; every reduction of the cache over the batch is over the
    whole batch (:mod:`fdtpu_torch.dist.parallel`), so every rank takes the
    same decisions.  :meth:`sample` returns the whole batch on every rank (an
    ``all_gather``), as the JAX package returns the global array;
    ``last_cache_state`` holds this rank's rows.  A ``model`` axis of the mesh
    repeats the same work on each of its ranks.
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
        self.mesh = mesh
        self.shard: Optional[Axis] = None
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a torch DeviceMesh (fdtpu_torch.dist.create_mesh), "
                                f"got {type(mesh).__name__}")
            self.shard = Axis.of(mesh, "data")
            self.shard.rows(sample_batch_size)
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
        self.last_modes: Optional[torch.Tensor] = None
        self.last_rows: Optional[torch.Tensor] = None
        self._last_stats: Optional[dict] = None
        self.use_fresca = use_fresca
        self.fresca_low_scale = fresca_low_scale
        self.fresca_high_scale = fresca_high_scale
        self.fresca_cutoff_ratio = fresca_cutoff_ratio
        self.fresca_cutoff_strategy = fresca_cutoff_strategy
        self.batches_per_call = max(1, int(batches_per_call))
        # The policy knobs of the resident chains, device tensors their graphs read.
        self.policy_params = cfg.policy_params(self.device) if cfg is not None else None
        self._chains: dict[tuple, Any] = {}

    def set_tau_0(self, tau_0: float) -> None:
        """Change the skip budget τ₀ in place: the captured graphs read it
        from the device, so they stay valid."""
        self.cache_config = dataclasses.replace(self.cache_config, tau_0=float(tau_0))
        self.policy_params.tau_0.fill_(float(tau_0))

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

    def _local(self, batch_size: int) -> int:
        """This rank's rows of a batch of ``batch_size``."""
        if self.shard is None:
            return batch_size
        rows = self.shard.rows(batch_size)
        return rows.stop - rows.start

    def _rows(self, x: Optional[torch.Tensor], dim: int = 0) -> Optional[torch.Tensor]:
        """This rank's rows of an injected draw of the whole batch (axis ``dim``)."""
        if x is None or self.shard is None:
            return x
        return x.narrow(dim, self.shard.index * self._local(x.shape[dim]),
                        self._local(x.shape[dim]))

    def _init_cache(self, batch_size: int) -> Optional[CacheState]:
        """A fresh cache for a batch of ``batch_size`` (this rank's rows of it)."""
        if not self.use_cache:
            return None
        cfg = self.score_model.config
        return init_cache_state(
            self.cache_config, self._local(batch_size), self.max_len, self.n_channels,
            self.device,
            num_layers=cfg.num_layers, n_head=cfg.n_head, head_dim=cfg.head_dim,
            d_model=cfg.d_model, kv_dtype=cfg._cdtype,
        )

    def sample_prior(
        self,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The prior sample of a batch (under a mesh, this rank's rows of it;
        ``noise``, when given, is the whole batch's)."""
        if noise is not None:
            noise = self._rows(noise.to(self.device))
        if self.shard is not None and generator is not None:
            generator = ShardedGenerator(generator, self.shard)
        return self.noise_scheduler.prior_sampling(
            (self._local(batch_size), self.max_len, self.n_channels), generator, self.device,
            noise)

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
        num_steps = num_diffusion_steps
        if num_steps is None:
            num_steps = self.score_model.num_training_steps
        if generator is None and any(a is None for a in (prior_noise, step_noise, probe_noise)):
            generator = torch.Generator(device=self.device).manual_seed(0)

        num_batches = max(1, num_samples // self.sample_batch_size)
        batch = min(num_samples, self.sample_batch_size)
        resident = self.batches_per_call > 1 and num_batches > 1
        level = self.cache_config.level if self.use_cache else None
        with span("fdtpu.sample", level=level, batches=num_batches, steps=num_steps):
            chain = self._chain(batch, num_steps, prior_noise is not None,
                                step_noise is not None, probe_noise is not None, resident)
            fresh_state = self._init_cache(batch)
            chain.begin_call(generator)
            all_samples, modes, rows_taken = [], [], []
            for batch_idx in range(num_batches):
                rows = slice(batch_idx * batch, (batch_idx + 1) * batch)
                with span("fdtpu.sample.load", batch=batch_idx):
                    chain.load(
                        None if prior_noise is None else self.sample_prior(batch, None,
                                                                           prior_noise[rows]),
                        None if step_noise is None else self._rows(step_noise[:, rows], 1),
                        None if probe_noise is None else probe_noise[batch_idx])
                    if self.use_cache:
                        if batch_idx == 0 or self.cache_config.reset_between_batches:
                            chain.reset(fresh_state)
                        else:
                            chain.mark_cold()
                if resident:
                    chain.run_resident()
                else:
                    chain.run_eager()
                with span("fdtpu.sample.gather", batch=batch_idx):
                    all_samples.append(self._gather(chain.x.clone()))
                    if self.use_cache:
                        modes.append(chain.modes.clone())
                    if chain.rows is not None:
                        rows_taken.append(chain.rows.clone())
            chain.end_call(generator)
            with span("fdtpu.sample.read"):
                cache_state, stats = chain.read(stats=True)
            with span("fdtpu.sample.finish"):
                self.last_cache_state = cache_state
                self.last_modes = torch.stack(modes) if modes else None
                self.last_rows = torch.stack(rows_taken) if rows_taken else None
                self._last_stats = (None if cache_state is None
                                    else cache_stats(cache_state, stats, self._shards()))
                self._check_error_budget()
                return torch.cat(all_samples, dim=0)

    def _chain(self, batch: int, num_steps: int, inject_prior: bool, inject_steps: bool,
               inject_probes: bool, resident: bool):
        """The sampler's chain for batches of ``batch``, made at first use."""
        from fdtpu_torch.sampling.resident import Chain

        key = (batch, num_steps, inject_prior, inject_steps, inject_probes, resident)
        chain = self._chains.get(key)
        if chain is None:
            chain = Chain(
                self.score_model.network, self.noise_scheduler, self.cache_config,
                self.policy_params, self._init_cache(batch), self._local(batch), num_steps,
                self._fresca_fn(num_steps), self.device, resident=resident,
                inject_steps=inject_steps, inject_probes=inject_probes,
                draw_prior=not inject_prior, shard=self.shard,
            )
            self._chains[key] = chain
        return chain

    def _fresca_fn(self, num_steps: int):
        return _fresca(self.use_fresca, self.fresca_low_scale, self.fresca_high_scale,
                       self.fresca_cutoff_ratio, self.fresca_cutoff_strategy, num_steps,
                       None if self.shard is None else self.shard.group)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch from this rank's rows."""
        return gather_batch(x, None if self.shard is None else self.shard.group)

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
        return dict(self._last_stats)

    def _shards(self) -> int:
        return 1 if self.shard is None else self.shard.size
