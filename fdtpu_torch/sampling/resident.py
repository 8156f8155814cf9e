"""The reverse chain with its E²-CRF decisions on the device: one CUDA graph
a trajectory (port of ``fdtpu/sampling/sampler.py:99-635`` and of
``_sample_batches_resident``, ``:686-784``).

The JAX package scans a trajectory in one program: ``lax.scan`` over the
steps, ``lax.cond`` (score level) or ``lax.switch`` (token level) on the
cache's decision, the KV level's mode passed into the forward.  A
:class:`Chain` holds one sampler's trajectory at one batch size and step
count as functions of static tensors:

* ``pre``: the decision of the step (:mod:`fdtpu_torch.cache.e2crf`, one
  definition each) written as a branch index into ``mode``, the step's mode
  into ``modes[i]`` and the branch's run count;
* one branch per host value the step's code takes (score level: skip,
  refresh, cold refresh; token level: FULL, TOPK, SKIP, cold FULL; KV
  level: FULL, MIXED, CACHED, each with and without a FreqCa ring entry),
  each writing the step's score and the new cache state in place;
* ``post``: FreSca, the Euler–Maruyama update, the counters
  (:func:`~fdtpu_torch.cache.e2crf.count_mode`) and the clock.

On a card, at the score level with the Taylor predictor, ``pre``, the skip
branch and ``post`` are one hand-written kernel each
(:mod:`fdtpu_torch.kernels.chain_step`: the same arithmetic in the same
order, so the same samples and decisions), FreSca where it is on staying
the PyTorch call before ``post``'s kernel.  Every other chain, and every
chain on the CPU, runs these segments as PyTorch ops.

The counters live in ``clock``, an int64 device vector: ``[i, step,
last_full_step, cold, recompute_count, cache_hit_count, full_steps,
mixed_steps, cached_steps, runs of branch 0, …]``.

Two ways to run it, on the same functions:

* :meth:`Chain.run_eager` (``sample_chain``, ``batches_per_call=1``): each
  step runs ``pre``, reads ``mode`` with one ``.item()``, runs that branch
  and ``post``; the noise and the probe uniforms are drawn as the step needs
  them;
* :meth:`Chain.run_resident` (``batches_per_call > 1``): a prologue draws
  the prior, then each step's probe uniforms (token level every step; KV
  event level with probes) and step noise, in the eager loop's order, one
  draw per step and kind; then the steps run with no host read.  On a
  CUDA device that is one replay of a :class:`~fdtpu_torch.utils.conditional.LoopGraph`
  (a WHILE node over the steps, an IF node per branch), captured at the
  chain's first run; on the CPU the same functions run as a loop that reads
  ``mode`` each step.

The samples, modes and counters of the two are equal: the same functions on
the same numbers, the draws of the prologue in the order the eager loop
makes them.  Between trajectories of one call the cross-batch preparation
(:meth:`Chain.reset`, :meth:`Chain.mark_cold`) is enqueued on the device;
the counters, branch runs and statistics are read once, at the end of a
call (:meth:`Chain.read`).  A replay, the capture and the read are spans of
:mod:`fdtpu_torch.utils.profiling` (``fdtpu.sample.*``; a replay's with its
device interval), and the read adds the call's ``chain.*`` counters: the
steps, each branch's runs and the graph's kernel nodes.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import torch

from fdtpu_torch.cache.e2crf import (
    COUNTERS,
    MODE_CACHED,
    MODE_FULL,
    MODE_MIXED,
    TOKEN_FULL,
    TOKEN_SKIP,
    TOKEN_TOPK,
    CacheState,
    E2CRFConfig,
    PolicyParams,
    count_mode,
    counter_view,
    counters_of,
    event_policy,
    kv_ring_due,
    kv_state_update,
    macro_policy,
    score_skip_decision,
    stat_tensor,
    token_policy,
    with_counters,
)
from fdtpu_torch.diffusion.sde import SDE, noise_scaling_vector
from fdtpu_torch.dist.parallel import Axis, ShardedGenerator, batch_first, draw
from fdtpu_torch.kernels import chain_step
from fdtpu_torch.models.score_models import ScoreNetwork, score_apply_cached
from fdtpu_torch.sampling.sampler import _refresh, _skip, _token_mode_step, no_fresca
from fdtpu_torch.utils.graphs import CudaGraph, launch_counts, set_counts, write_back
from fdtpu_torch.utils.profiling import count, settle, span

N_COUNTERS = len(COUNTERS)
COLD = 1 + COUNTERS.index("cold")
RUNS = 1 + N_COUNTERS  # clock index of branch 0's run count
TOKEN_COLD_FULL = 3  # the token level's branch of a FULL step on a cold cache


def cache_tensors(state: CacheState) -> dict[str, torch.Tensor]:
    """The state's tensor fields (every field but the counters)."""
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if f.name not in COUNTERS}


class Chain:
    """One sampler's reverse chain at one batch size and step count (module
    docstring).  ``state`` is the cache to start from (None uncached); its
    tensors are cloned into the chain's static tensors.  ``resident``
    chains hold the whole trajectory's noise; ``inject_steps`` /
    ``inject_probes`` mean the caller hands the step noise / the probe
    uniforms in (:meth:`load`), and ``draw_prior`` that the prologue draws
    the prior sample.  ``guard_trace`` (score level) records each step's
    guard telemetry.  ``shard`` (a mesh's data axis) makes the chain one
    rank's rows of a batch of ``batch × shard.size``: the batch's draws are
    made whole from the shared generator and cut to the rank's rows, and
    the cache's reductions over the batch are over the whole batch
    (:mod:`fdtpu_torch.dist.parallel`), so the collectives run inside the
    steps (and the captured graph).  At the token level ``rows`` keeps the
    rows each TOPK step takes ((steps, budget) int64, −1 at the other steps),
    cleared at the start of each trajectory."""

    def __init__(
        self,
        network: ScoreNetwork,
        scheduler: SDE,
        cache_cfg: Optional[E2CRFConfig],
        pp: Optional[PolicyParams],
        state: Optional[CacheState],
        batch: int,
        num_steps: int,
        fresca: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        device,
        *,
        resident: bool,
        inject_steps: bool = False,
        inject_probes: bool = False,
        draw_prior: bool = False,
        guard_trace: bool = False,
        shard: Optional[Axis] = None,
    ) -> None:
        mcfg = network.config
        self.network = network.compute_copy()
        self.device = torch.device(device)
        # Every tensor a graph reads lives on the device: a capture refuses a
        # copy from the host.
        if scheduler.G is not None:
            scheduler = dataclasses.replace(scheduler, G=scheduler.G.to(self.device))
        self.scheduler = scheduler
        self.cfg, self.pp, self.fresca = cache_cfg, pp, fresca
        self.level = None if cache_cfg is None else cache_cfg.level
        self.step_kernels = (self.device.type == "cuda" and self.level == "score"
                             and cache_cfg.eps_predictor == "taylor")
        self.num_steps, self.batch, self.max_len = num_steps, batch, mcfg.max_len
        self.inject_steps, self.inject_probes, self.draw_prior = (
            inject_steps, inject_probes, draw_prior)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.x = zeros(batch, mcfg.max_len, mcfg.n_channels)
        self.score = torch.zeros_like(self.x)
        self.ts, self.step_size = scheduler.timesteps(num_steps, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.group = None if shard is None else shard.group
        # Where the batch's draws come from: the whole batch's, cut to this rank's rows.
        self.batch_draws = (self.generator if shard is None
                            else ShardedGenerator(self.generator, shard))
        self.draws_probe = self.level == "token" or (
            self.level == "kv" and cache_cfg.policy == "event"
            and cache_cfg.resolved_random_probe_ratio > 0.0)
        self.noise = (zeros(num_steps, *self.x.shape) if resident or inject_steps else None)
        self.probes = (zeros(num_steps, mcfg.max_len)
                       if self.draws_probe and (resident or inject_probes) else None)
        self.trace = zeros(num_steps, 5) if guard_trace else None
        self.rows = (torch.full((num_steps, min(int(cache_cfg.token_budget), mcfg.max_len)), -1,
                                dtype=torch.int64, device=self.device)
                     if self.level == "token" else None)

        branches = self._functions()[1]
        self.clock = zeros(RUNS + len(branches), dtype=torch.int64)
        self.run_counters = [f"chain.runs.{name}" for name, _ in branches]
        self.mode = zeros(dtype=torch.int64)  # the branch of the step
        self.sem = zeros(dtype=torch.int64)  # the step's mode (the JAX package's)
        self.modes = zeros(num_steps, dtype=torch.int64) if self.level else None
        self.one = torch.ones((1,), dtype=torch.int64, device=self.device)
        # The score level's step kernels (module docstring): their noise
        # scaling and the post kernel's count of finished blocks.
        if self.step_kernels:
            self.G = (scheduler.G if scheduler.G is not None else
                      noise_scaling_vector(mcfg.max_len, scheduler.fourier_noise_scaling,
                                           self.device))
            self.done = zeros(dtype=torch.int32)
        self.state, self.tensors = None, {}
        if state is not None:
            t = mcfg.max_len
            self.mask = zeros(t, dtype=torch.bool)
            self.count = zeros(dtype=torch.int64)
            self.w_drift, self.mean_drift = zeros(t), zeros()
            self.probe_now = zeros(t)
            self.low_bonus = torch.where(torch.arange(t, device=self.device) < pp.K, 2e9, 0.0)
            self.state = state
            self.tensors = {k: v.clone() for k, v in cache_tensors(state).items()}
            self.clock[1:RUNS].copy_(counters_of(state))
        self.loop = None  # the captured trajectory, at the first resident run on a card
        self.replays = 0

    # ------------------------------------------------------------ the host
    def view(self) -> CacheState:
        """The cache state on the static tensors, counters as 0-d views."""
        return counter_view(self.state.replace(**self.tensors), self.clock[1:RUNS])

    def load(self, x0: Optional[torch.Tensor] = None, step_noise: Optional[torch.Tensor] = None,
             probe_noise: Optional[torch.Tensor] = None) -> None:
        """Copy a trajectory's prior sample and injected draws in (enqueued;
        nothing is read back)."""
        if x0 is not None:
            self.x.copy_(x0)
        if step_noise is not None:
            self.noise.copy_(step_noise)
        if probe_noise is not None and self.probes is not None:
            self.probes.copy_(probe_noise)

    def reset(self, fresh: CacheState) -> None:
        """Take a freshly initialised state's values, in place."""
        write_back(self.tensors, cache_tensors(fresh))
        self.clock[1:RUNS].copy_(counters_of(fresh))

    def mark_cold(self) -> None:
        """Quirk Q5's cross-batch prep, in place (``_prep_cache_for_new_batch``)."""
        self.tensors["drift_rate"].zero_()
        self.clock[COLD].fill_(1)

    def begin_call(self, generator: Optional[torch.Generator]) -> None:
        """Take the caller's generator state and zero the branch runs."""
        if generator is not None:
            self.generator.set_state(generator.get_state())
        self.clock[RUNS:].zero_()
        self.replays = 0

    def end_call(self, generator: Optional[torch.Generator]) -> None:
        """Hand the generator state back."""
        if generator is not None:
            generator.set_state(self.generator.get_state())

    def read(self, stats: bool = False) -> tuple[Optional[CacheState], Optional[list]]:
        """One device read: the counters (the host fields of the returned
        state, whose tensors are clones of the static ones) and, with
        ``stats``, what :func:`~fdtpu_torch.cache.e2crf.cache_stats` reads.
        On a card, the launches of this call's replays are added to the
        kernel wrappers' counts (the branches' capture counts times their
        runs).  The replays' steps, each branch's runs and, on a card, their
        kernel nodes go to the recorder's counters (``chain.*``,
        :mod:`fdtpu_torch.utils.profiling`)."""
        steps = self.replays * self.num_steps
        if self.state is None:  # one branch, every step: nothing to read
            self._count_launches(steps, [steps])
            return None, None
        parts = [self.clock.double()] + ([stat_tensor(self.view())] if stats else [])
        values = torch.cat(parts).tolist()
        settle()
        clock = values[:self.clock.shape[0]]
        self._count_launches(steps, [int(n) for n in clock[RUNS:]])
        state = with_counters(
            self.state.replace(**{k: v.clone() for k, v in self.tensors.items()}),
            clock[1:RUNS])
        return state, (values[len(clock):] if stats else None)

    def _count_launches(self, steps: int, runs: list[int]) -> None:
        if self.replays:
            count("chain.steps", steps)
            for name, n in zip(self.run_counters, runs):
                count(name, n)
        if self.loop is not None:
            *added, kernels = self.loop.launches(self.replays, steps, runs)
            set_counts(a + b for a, b in zip(launch_counts(), added))
            if self.loop.counted:
                count("chain.kernels", kernels)
        self.replays = 0
        self.clock[RUNS:].zero_()

    # ----------------------------------------------------------- the loops
    @torch.no_grad()
    def run_eager(self) -> None:
        """One trajectory from ``x``, a host read of the branch each step."""
        self.clock[0].fill_(0)
        if self.rows is not None:
            self.rows.fill_(-1)
        for _ in range(self.num_steps):
            self._step()

    @torch.no_grad()
    def run_resident(self) -> None:
        """One trajectory, its draws made up front: one graph replay on a
        card, a loop on the CPU."""
        if self.device.type != "cuda":
            with span("fdtpu.sample.replay"):
                self._prologue()
                for _ in range(self.num_steps):
                    self._step()
        else:
            if self.loop is None:
                with span("fdtpu.sample.capture"):
                    self._capture()
            with span("fdtpu.sample.replay", device=True):
                self.loop.replay()
        self.replays += 1

    def _functions(self) -> tuple[Optional[Callable[[], None]],
                                  list[tuple[str, Callable[[], None]]]]:
        """The step's decision (None uncached) and its named branches, made
        anew at each call: a chain keeps no reference to itself, so dropping
        it frees its graphs at once, not at a garbage collection that may
        fall inside another graph's capture (where destroying a graph is
        refused)."""
        if self.level == "score":
            if self.step_kernels:
                return self._score_pre_kernel, [
                    ("skip", self._skip_kernel), ("refresh", partial(self._refresh, False)),
                    ("cold_refresh", partial(self._refresh, True))]
            return self._score_pre, [("skip", self._skip),
                                     ("refresh", partial(self._refresh, False)),
                                     ("cold_refresh", partial(self._refresh, True))]
        if self.level == "token":
            return self._token_pre, [(name, partial(self._token, mode, cold))
                                     for name, mode, cold in (
                                         ("full", TOKEN_FULL, False), ("topk", TOKEN_TOPK, False),
                                         ("skip", TOKEN_SKIP, False),
                                         ("cold_full", TOKEN_FULL, True))]
        if self.level == "kv":
            rings = (False, True) if self.cfg.use_freqca else (False,)
            return self._kv_pre, [("ring_" * ring + name, partial(self._kv, mode, ring))
                                  for ring in rings for name, mode in (
                                      ("full", MODE_FULL), ("mixed", MODE_MIXED),
                                      ("cached", MODE_CACHED))]
        return None, [("forward", self._uncached)]

    def _step(self) -> None:
        pre, branches = self._functions()
        if pre is None:
            branches[0][1]()
        else:
            pre()
            branches[int(self.mode.item())][1]()
        self._post()

    def _capture(self) -> None:
        """Warm every function up outside a capture (kernels built, library
        handles made), put the static tensors back, capture the loop."""
        from fdtpu_torch.utils.conditional import LoopGraph

        statics = [self.x, self.score, self.clock, self.mode, self.sem, self.noise,
                   self.probes, self.modes, self.rows, *self.tensors.values()]
        if self.state is not None:
            statics += [self.mask, self.count, self.w_drift, self.mean_drift, self.probe_now]
        saved = [(t, t.clone()) for t in statics if t is not None]
        gen_state = self.generator.get_state()
        counts = launch_counts()
        pre, named = self._functions()
        branches = [fn for _, fn in named]
        for fn in [self._prologue, *([pre] if pre else []), *branches, self._post]:
            CudaGraph.warm_up(fn)
        set_counts(counts)
        for t, value in saved:
            t.copy_(value)
        self.generator.set_state(gen_state)
        self.loop = LoopGraph(self._prologue, pre, branches, self._post, self.mode,
                              self.clock, self.num_steps, (self.generator,))

    # -------------------------------------- the steps' functions (static tensors)
    def _prologue(self) -> None:
        """The trajectory's draws, in the eager loop's order."""
        self.clock[0].fill_(0)
        if self.rows is not None:
            self.rows.fill_(-1)
        if self.draw_prior:
            self.x.copy_(self.scheduler.prior_sampling(self.x.shape, self.batch_draws,
                                                       self.device))
        for i in range(self.num_steps):
            if self.probes is not None and not self.inject_probes:
                self.probes[i].copy_(torch.rand((self.max_len,), generator=self.generator,
                                                device=self.device))
            if not self.inject_steps:
                self.noise[i].copy_(draw(torch.randn, self.x.shape, self.batch_draws,
                                         self.device))

    def _now(self) -> tuple[torch.Tensor, torch.Tensor]:
        t = self.ts.index_select(0, self.clock[0:1]).reshape(())
        return t, t.expand(self.batch)

    def _draw_noise(self) -> torch.Tensor:
        if self.noise is not None:
            return self.noise.index_select(0, self.clock[0:1])[0]
        return draw(torch.randn, self.x.shape, self.batch_draws, self.device)

    def _draw_probe(self) -> torch.Tensor:
        if self.probes is not None:
            return self.probes.index_select(0, self.clock[0:1])[0]
        return torch.rand((self.max_len,), generator=self.generator, device=self.device)

    def _since(self) -> torch.Tensor:
        return self.clock[1] - self.clock[2]

    def _set_mode(self, sem: torch.Tensor, branch: torch.Tensor) -> None:
        self.sem.copy_(sem)
        self.mode.copy_(branch)
        self.modes.index_copy_(0, self.clock[0:1], sem.reshape(1))
        self.clock.index_add_(0, RUNS + branch.reshape(1), self.one)

    def _finish_branch(self, score: torch.Tensor, state: Optional[CacheState] = None) -> None:
        self.score.copy_(score)
        if state is not None:
            write_back(self.tensors, cache_tensors(state))

    def _post(self) -> None:
        """FreSca, the Euler–Maruyama update, the counters, the clock."""
        if self.step_kernels:
            self._post_kernel()
            return
        t, _ = self._now()
        x = self.scheduler.step(self.fresca(self.score, t), t, self.x, self._draw_noise(),
                                self.step_size)
        self.x.copy_(x)
        if self.level is not None:
            n = None
            if self.level == "kv":
                n = self.count
            elif self.level == "token":
                n = min(int(self.cfg.token_budget), self.max_len)
            c = count_mode(self.view(), self.level, self.sem, self.max_len, n)
            c = c.replace(step=c.step + 1)
            self.clock[1:RUNS].copy_(torch.stack([getattr(c, k) for k in COUNTERS]))
        self.clock[0:1].add_(self.one)

    def _uncached(self) -> None:
        _, t_batch = self._now()
        self._finish_branch(self.network(self.x, t_batch))

    def _score_pre(self) -> None:
        c = self.view()
        compute = score_skip_decision(self.cfg, self.pp, c)
        self._set_mode(compute, compute * (1 + c.cold))

    def _refresh(self, cold: bool) -> None:
        t, t_batch = self._now()
        _, std = self.scheduler.marginal_prob(self.x, t_batch)
        score, c, trace = _refresh(self.network, self.view().replace(cold=cold), self.cfg,
                                   self.pp, self.x, t, t_batch, std, self._since(), self.group)
        if self.trace is not None:
            row = torch.stack([torch.zeros_like(t) + v for v in trace])
            self.trace.index_copy_(0, self.clock[0:1], row.reshape(1, -1))
        self._finish_branch(score, c)

    def _skip(self) -> None:
        t, t_batch = self._now()
        _, std = self.scheduler.marginal_prob(self.x, t_batch)
        score, c = _skip(self.view().replace(cold=False), self.cfg, t, std, self._since())
        self._finish_branch(score, c)

    def _score_pre_kernel(self) -> None:
        c = self.tensors
        chain_step.score_pre(self.clock, self.mode, self.sem, self.modes, c["drift_rate"],
                             c["err_acc"], self.pp.tau_0, c["overrun"], self.pp.R,
                             self.cfg.auto_calibrate)

    def _skip_kernel(self) -> None:
        c = self.tensors
        chain_step.score_skip(self.clock, self.ts, self.G, c["eps_hat"], c["eps_prev"],
                              c["eps_prev2"], c["eps_gap"], c["eps_gap2"], c["drift_rate"],
                              c["err_acc"], self.score, self.cfg.eps_order, self.scheduler)

    def _post_kernel(self) -> None:
        score = self.score
        if self.fresca is not no_fresca:
            t, _ = self._now()
            score = self.fresca(score, t).contiguous()
        noise = self.noise if self.noise is not None else self._draw_noise()
        chain_step.score_post(self.clock, self.sem, self.ts, self.step_size, self.G, score, noise,
                              self.x, self.done, self.scheduler, self.max_len)

    def _token_pre(self) -> None:
        self.probe_now.copy_(self._draw_probe())
        c = self.view()
        mode, w_drift, mean_drift = token_policy(self.cfg, self.pp, c, self.x, self.group)
        self.w_drift.copy_(w_drift)
        self.mean_drift.copy_(mean_drift)
        cold_full = (mode == TOKEN_FULL) & (c.cold != 0)
        self._set_mode(mode, torch.where(cold_full, TOKEN_COLD_FULL, mode))

    def _token(self, mode: int, cold: bool) -> None:
        t, t_batch = self._now()
        _, std = self.scheduler.marginal_prob(self.x, t_batch)
        c = self.view()
        score, c = _token_mode_step(self.network, c.replace(cold=cold), self.cfg, self.pp,
                                    self.x, t_batch, std, self.low_bonus, self.probe_now, mode,
                                    self.w_drift, self.mean_drift, c.step, self.group,
                                    self._record_rows)
        self._finish_branch(score, c)

    def _record_rows(self, idx: torch.Tensor) -> None:
        self.rows.index_copy_(0, self.clock[0:1], idx[None])

    def _kv_pre(self) -> None:
        c = self.view()
        if self.cfg.policy == "macro":
            mode, mask, count = macro_policy(self.pp, c, self.max_len)
        else:
            probe = self._draw_probe() if self.draws_probe else None
            mode, mask, count = event_policy(self.cfg, self.pp, c, self.x, probe, self.group)
        self.mask.copy_(mask)
        self.count.copy_(count)
        branch = mode
        if self.cfg.use_freqca:
            branch = mode + 3 * kv_ring_due(self.cfg, c).to(torch.int64)
        self._set_mode(mode, branch)

    def _kv(self, mode: int, ring: bool) -> None:
        t, t_batch = self._now()
        c = self.view()
        score, kv, crf = score_apply_cached(self.network, self.x, t_batch, (c.k, c.v), self.mask,
                                            mode)
        # The CRF is the batch's first sample's: the first rank's.
        crf = batch_first(crf, self.group)
        self._finish_branch(score, kv_state_update(self.cfg, c, kv, crf, t, ring))
