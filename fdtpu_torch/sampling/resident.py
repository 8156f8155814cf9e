"""The reverse chain: one step table, and the chain that runs it in place
(port of ``fdtpu/sampling/sampler.py:99-635`` and of
``_sample_batches_resident``, ``:686-784``).

The JAX package scans a trajectory in one program: ``lax.scan`` over the
steps, ``lax.cond`` (score level) or ``lax.switch`` (token level) on the
cache's decision, the KV level's mode passed into the forward.  Every way
the port runs a trajectory — the eager loop, the resident graph, the
exported program (:mod:`fdtpu_torch.serve.export`) — takes its step from
one :class:`StepTable`, whose functions return values and write nothing:

* ``decide``: the step's decision (:mod:`fdtpu_torch.cache.e2crf`, one
  definition each) as the step's mode, its branch, the branches' extra
  operands and the count of recomputed tokens that
  :func:`~fdtpu_torch.cache.e2crf.count_mode` takes;
* one branch per host value the step's code takes (score level: skip,
  refresh, cold refresh; token level: FULL, TOPK, SKIP, cold FULL; KV
  level: FULL, MIXED, CACHED, each with and without a FreqCa ring entry),
  each returning the step's score and the new cache state;
* ``update`` and ``counters``: FreSca, the Euler–Maruyama update, the
  counters (:func:`~fdtpu_torch.cache.e2crf.count_mode`) and ``step + 1``.

The step's arithmetic inside the branches is :mod:`fdtpu_torch.sampling.sampler`'s.

A :class:`Chain` holds one sampler's trajectory at one batch size and step
count as static tensors and runs the table on them in place: ``pre`` writes
the decision's branch index into ``mode``, the step's mode into
``modes[i]`` and the branch's run count; each branch writes the step's
score and the cache state; ``post`` writes x, the counters and the clock.
On a card, at the score level with the Taylor predictor, ``pre``, the skip
branch and ``post`` are one hand-written kernel each
(:mod:`fdtpu_torch.kernels.chain_step`: the table's arithmetic in the same
order, so the same samples and decisions), FreSca where it is on staying
the PyTorch call before ``post``'s kernel.

The counters live in ``clock``, an int64 device vector: ``[i, step,
last_full_step, cold, recompute_count, cache_hit_count, full_steps,
mixed_steps, cached_steps, runs of branch 0, …]``.

Two ways to run a chain, on the same functions:

* :meth:`Chain.run_eager` (``sample_chain``; ``DiffusionSampler`` with
  ``batches_per_call=1`` or one batch): each step runs ``pre``, reads
  ``mode`` with one ``.item()``, runs that branch and ``post``; the noise
  and the probe uniforms are drawn as the step needs them;
* :meth:`Chain.run_resident` (``batches_per_call > 1`` and more than one
  batch): a prologue draws the prior, then each step's probe uniforms
  (token level every step; KV event level with probes) and step noise, in
  the eager loop's order, one draw per step and kind; then the steps run
  with no host read.  On a CUDA device that is one replay of a
  :class:`~fdtpu_torch.utils.conditional.LoopGraph` (a WHILE node over the
  steps, an IF node per branch), captured at the chain's first run; on the
  CPU the same functions run as a loop that reads ``mode`` each step.

The samples, modes and counters of the two are equal: the same functions on
the same numbers, the draws of the prologue in the order the eager loop
makes them.  Between trajectories of one call the cross-batch preparation
(:meth:`Chain.reset`, :meth:`Chain.mark_cold`) is enqueued on the device;
the counters, branch runs and statistics are read once, at the end of a
call (:meth:`Chain.read`).  A replay, the capture and the read are spans of
:mod:`fdtpu_torch.utils.profiling` (``fdtpu.sample.*``; a replay's with its
device interval), and the read adds the call's ``chain.*`` counters of the
replays: the steps, each branch's runs and the graph's kernel nodes.
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
from fdtpu_torch.dist.parallel import Axis, Group, ShardedGenerator, batch_first, draw
from fdtpu_torch.kernels import chain_step
from fdtpu_torch.models.score_models import ScoreNetwork, score_apply_cached
from fdtpu_torch.sampling.sampler import _refresh, _skip, _token_mode_step, no_fresca
from fdtpu_torch.utils.graphs import CudaGraph, add_counts, uncounted, write_back
from fdtpu_torch.utils.profiling import count, settle, span

N_COUNTERS = len(COUNTERS)
COLD = 1 + COUNTERS.index("cold")
RUNS = 1 + N_COUNTERS  # clock index of branch 0's run count
TOKEN_COLD_FULL = 3  # the token level's branch of a FULL step on a cold cache
KV_MODES = 3  # the KV level's branches without a ring entry; those with one follow


def cache_tensors(state: CacheState) -> dict[str, torch.Tensor]:
    """The state's tensor fields (every field but the counters)."""
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if f.name not in COUNTERS}


class StepTable:
    """Each level's step, once (module docstring): functions of the cache
    state ``c`` (counters as 0-d tensors), ``x`` and the step's time ``t``
    (a 0-d tensor) that return new values.  ``group`` as in
    :func:`~fdtpu_torch.sampling.sampler._refresh`.  ``ring_branches``:
    the KV level's FreqCa ring entry is a branch of its own (the chain's
    graph), or left to the caller, which then gets the KV branches without
    it and the mode as their index (the exported program, which traces each
    forward once)."""

    def __init__(self, network: ScoreNetwork, scheduler: SDE, cfg: Optional[E2CRFConfig],
                 pp: Optional[PolicyParams],
                 fresca: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 step_size: torch.Tensor, batch: int, group: Group = None,
                 ring_branches: bool = True) -> None:
        self.network, self.scheduler, self.cfg, self.pp = network, scheduler, cfg, pp
        self.fresca, self.step_size, self.batch, self.group = fresca, step_size, batch, group
        self.level = None if cfg is None else cfg.level
        self.max_len = network.config.max_len
        self.draws_probe = self.level == "token" or (
            self.level == "kv" and cfg.policy == "event" and cfg.resolved_random_probe_ratio > 0.0)
        self.rings = ((False, True) if self.level == "kv" and cfg.use_freqca and ring_branches
                      else (False,))
        if self.level == "token":
            self.budget = min(int(cfg.token_budget), self.max_len)
            self.low_bonus = torch.where(
                torch.arange(self.max_len, device=step_size.device) < pp.K, 2e9, 0.0)

    # ---------------------------------------------------------- the decision
    def decide(self, c: CacheState, x: torch.Tensor, probe: Optional[torch.Tensor]) -> tuple:
        """``(the step's mode, its branch, the branches' extra operands, the
        recomputed count of count_mode)``; ``probe``: the step's probe
        uniforms (T,), where the level draws them."""
        cfg, pp = self.cfg, self.pp
        if self.level == "score":
            compute = score_skip_decision(cfg, pp, c)
            return compute, compute * (1 + c.cold), (), None
        if self.level == "token":
            mode, w_drift, mean_drift = token_policy(cfg, pp, c, x, self.group)
            cold_full = (mode == TOKEN_FULL) & (c.cold != 0)
            return (mode, torch.where(cold_full, TOKEN_COLD_FULL, mode),
                    (probe, w_drift, mean_drift), self.budget)
        if cfg.policy == "macro":
            mode, mask, n = macro_policy(pp, c, self.max_len)
        else:
            mode, mask, n = event_policy(cfg, pp, c, x, probe, self.group)
        branch = mode
        if len(self.rings) > 1:
            branch = mode + KV_MODES * kv_ring_due(cfg, c).to(torch.int64)
        return mode, branch, (mask,), n

    # ---------------------------------------------------------- the branches
    def branches(self) -> list[tuple[str, Callable]]:
        """The branches by index, named; each ``fn(c, x, t, *extra,
        record=None) -> (score, new cache state)``.  ``record``, if given,
        is handed what the step records: a refresh's guard telemetry
        ``(measured, rel, eps_norm, err_acc, steps_since)``, a TOPK step's
        rows."""
        if self.level == "score":
            return [("skip", self.skip), ("refresh", partial(self.refresh, False)),
                    ("cold_refresh", partial(self.refresh, True))]
        if self.level == "token":
            return [(name, partial(self.token, mode, cold)) for name, mode, cold in (
                ("full", TOKEN_FULL, False), ("topk", TOKEN_TOPK, False),
                ("skip", TOKEN_SKIP, False), ("cold_full", TOKEN_FULL, True))]
        if self.level == "kv":
            return [("ring_" * ring + name, partial(self.kv, mode, ring))
                    for ring in self.rings for name, mode in (
                        ("full", MODE_FULL), ("mixed", MODE_MIXED), ("cached", MODE_CACHED))]
        return [("forward", self.forward)]

    def _std(self, x: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        t_batch = t.expand(self.batch)
        return t_batch, self.scheduler.marginal_prob(x, t_batch)[1]

    def forward(self, c, x, t, record=None):
        return self.network(x, t.expand(self.batch)), None

    def skip(self, c, x, t, record=None):
        _, std = self._std(x, t)
        return _skip(c.replace(cold=False), self.cfg, t, std, c.step - c.last_full_step)

    def refresh(self, cold: bool, c, x, t, record=None):
        t_batch, std = self._std(x, t)
        score, c, trace = _refresh(self.network, c.replace(cold=cold), self.cfg, self.pp, x, t,
                                   t_batch, std, c.step - c.last_full_step, self.group)
        if record is not None:
            record(trace)
        return score, c

    def token(self, mode: int, cold: bool, c, x, t, probe, w_drift, mean_drift, record=None):
        t_batch, std = self._std(x, t)
        return _token_mode_step(self.network, c.replace(cold=cold), self.cfg, self.pp, x,
                                t_batch, std, self.low_bonus, probe, mode, w_drift, mean_drift,
                                c.step, self.group, record)

    def kv(self, mode: int, ring: bool, c, x, t, mask, record=None):
        score, kv, crf = score_apply_cached(self.network, x, t.expand(self.batch), (c.k, c.v),
                                            mask, mode)
        # The CRF is the batch's first sample's: the first rank's.
        crf = batch_first(crf, self.group)
        return score, kv_state_update(self.cfg, c, kv, crf, t, ring)

    # ------------------------------------------------------------ the update
    def update(self, score: torch.Tensor, t: torch.Tensor, x: torch.Tensor,
               noise: Callable[[], torch.Tensor]) -> torch.Tensor:
        """FreSca, then the Euler–Maruyama update with the step's noise,
        ``noise()``, taken after FreSca."""
        score = self.fresca(score, t)
        return self.scheduler.step(score, t, x, noise(), self.step_size)

    def counters(self, c: CacheState, sem: torch.Tensor, n) -> torch.Tensor:
        """The counters after a step in mode ``sem`` (``n`` recomputed, as
        :meth:`decide` gave it), ``step`` advanced: a vector in
        :data:`~fdtpu_torch.cache.e2crf.COUNTERS` order."""
        c = count_mode(c, self.level, sem, self.max_len, n)
        c = c.replace(step=c.step + 1)
        return torch.stack([getattr(c, k) for k in COUNTERS])


class Chain:
    """One sampler's reverse chain at one batch size and step count (module
    docstring).  ``state`` is the cache to start from (None uncached); its
    tensors are cloned into the chain's static tensors.  ``resident``
    chains hold the whole trajectory's noise; ``inject_steps`` /
    ``inject_probes`` mean the caller hands the step noise / the probe
    uniforms in (:meth:`load`), and ``draw_prior`` that each trajectory
    draws its prior sample (else :meth:`load` hands it in).  ``guard_trace``
    (score level) records each step's guard telemetry.  ``shard`` (a mesh's
    data axis) makes the chain one rank's rows of a batch of ``batch ×
    shard.size``: the batch's draws are made whole from the shared generator
    and cut to the rank's rows, and the cache's reductions over the batch
    are over the whole batch (:mod:`fdtpu_torch.dist.parallel`), so the
    collectives run inside the steps (and the captured graph).  At the token
    level ``rows`` keeps the rows each TOPK step takes ((steps, budget)
    int64, −1 at the other steps), cleared at the start of each
    trajectory."""

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
        self.resident = resident
        self.inject_steps, self.inject_probes, self.draw_prior = (
            inject_steps, inject_probes, draw_prior)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.x = zeros(batch, mcfg.max_len, mcfg.n_channels)
        self.score = torch.zeros_like(self.x)
        self.ts, self.step_size = scheduler.timesteps(num_steps, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.group = None if shard is None else shard.group
        self.table = StepTable(network.compute_copy(), scheduler, cache_cfg, pp, fresca,
                               self.step_size, batch, self.group)
        # Where the batch's draws come from: the whole batch's, cut to this rank's rows.
        self.batch_draws = (self.generator if shard is None
                            else ShardedGenerator(self.generator, shard))
        self.draws_probe = self.table.draws_probe
        self.noise = (zeros(num_steps, *self.x.shape) if resident or inject_steps else None)
        self.probes = (zeros(num_steps, mcfg.max_len)
                       if self.draws_probe and (resident or inject_probes) else None)
        self.trace = zeros(num_steps, 5) if guard_trace else None
        self.rows = (torch.full((num_steps, self.table.budget), -1, dtype=torch.int64,
                                device=self.device) if self.level == "token" else None)

        branches = self.table.branches()
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
        # The decision's outputs that the branches and post read: the
        # branches' extra operands and the KV level's recomputed count.
        t = mcfg.max_len
        self.extra = {"token": (zeros(t), zeros(t), zeros()),  # probe, w_drift, mean_drift
                      "kv": (zeros(t, dtype=torch.bool),)}.get(self.level, ())  # mask
        self.count = zeros(dtype=torch.int64) if self.level == "kv" else None
        self.recomputed = None
        self.state, self.tensors = None, {}
        if state is not None:
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
        """Quirk Q5's cross-batch preparation, in place: the store kept, the
        cache marked cold so that the new trajectory recomputes and
        re-calibrates its drift rate."""
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
            add_counts(added)
            if self.loop.counted:
                count("chain.kernels", kernels)
        self.replays = 0
        self.clock[RUNS:].zero_()

    # ----------------------------------------------------------- the loops
    @torch.no_grad()
    def run_eager(self) -> None:
        """One trajectory from ``x`` (or its drawn prior), a host read of the
        branch each step."""
        self._start()
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
        record = (self._record_rows if self.rows is not None
                  else self._record_trace if self.trace is not None else None)
        branches = [(name, partial(self._branch, fn, record))
                    for name, fn in self.table.branches()]
        if self.step_kernels:
            return self._score_pre_kernel, [("skip", self._skip_kernel), *branches[1:]]
        return (None if self.state is None else self._pre), branches

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
                   self.probes, self.modes, self.rows, *self.tensors.values(), *self.extra,
                   self.count]
        saved = [(t, t.clone()) for t in statics if t is not None]
        gen_state = self.generator.get_state()
        pre, named = self._functions()
        branches = [fn for _, fn in named]
        with uncounted():
            for fn in [self._prologue, *([pre] if pre else []), *branches, self._post]:
                CudaGraph.warm_up(fn)
        for t, value in saved:
            t.copy_(value)
        self.generator.set_state(gen_state)
        self.loop = LoopGraph(self._prologue, pre, branches, self._post, self.mode,
                              self.clock, self.num_steps, (self.generator,))

    # -------------------------------------- the steps' functions (static tensors)
    def _start(self) -> None:
        """A trajectory's start: the clock and the rows cleared, the prior
        drawn (``draw_prior``)."""
        self.clock[0].fill_(0)
        if self.rows is not None:
            self.rows.fill_(-1)
        if self.draw_prior:
            self.x.copy_(self.scheduler.prior_sampling(self.x.shape, self.batch_draws,
                                                       self.device))

    def _prologue(self) -> None:
        """The trajectory's draws, in the eager loop's order."""
        self._start()
        for i in range(self.num_steps):
            if self.probes is not None and not self.inject_probes:
                self.probes[i].copy_(torch.rand((self.max_len,), generator=self.generator,
                                                device=self.device))
            if not self.inject_steps:
                self.noise[i].copy_(draw(torch.randn, self.x.shape, self.batch_draws,
                                         self.device))

    def _now(self) -> torch.Tensor:
        return self.ts.index_select(0, self.clock[0:1]).reshape(())

    def _draw_noise(self) -> torch.Tensor:
        if self.noise is not None:
            return self.noise.index_select(0, self.clock[0:1])[0]
        return draw(torch.randn, self.x.shape, self.batch_draws, self.device)

    def _draw_probe(self) -> torch.Tensor:
        if self.probes is not None:
            return self.probes.index_select(0, self.clock[0:1])[0]
        return torch.rand((self.max_len,), generator=self.generator, device=self.device)

    def _pre(self) -> None:
        """The table's decision, its outputs written to the static tensors."""
        probe = self._draw_probe() if self.draws_probe else None
        sem, branch, extra, n = self.table.decide(self.view(), self.x, probe)
        for static, value in zip(self.extra, extra):
            static.copy_(value)
        self.recomputed = self.count.copy_(n) if isinstance(n, torch.Tensor) else n
        self._set_mode(sem, branch)

    def _set_mode(self, sem: torch.Tensor, branch: torch.Tensor) -> None:
        self.sem.copy_(sem)
        self.mode.copy_(branch)
        self.modes.index_copy_(0, self.clock[0:1], sem.reshape(1))
        self.clock.index_add_(0, RUNS + branch.reshape(1), self.one)

    def _branch(self, fn: Callable, record: Optional[Callable]) -> None:
        """A branch of the table, its score and cache state written in place."""
        c = None if self.state is None else self.view()
        score, state = fn(c, self.x, self._now(), *self.extra, record=record)
        self.score.copy_(score)
        if state is not None:
            write_back(self.tensors, cache_tensors(state))

    def _record_trace(self, trace: tuple) -> None:
        row = torch.stack([self.trace.new_zeros(()) + v for v in trace])
        self.trace.index_copy_(0, self.clock[0:1], row.reshape(1, -1))

    def _record_rows(self, idx: torch.Tensor) -> None:
        self.rows.index_copy_(0, self.clock[0:1], idx[None])

    def _post(self) -> None:
        """The table's update and counters, then the clock."""
        if self.step_kernels:
            self._post_kernel()
            return
        self.x.copy_(self.table.update(self.score, self._now(), self.x, self._draw_noise))
        if self.level is not None:
            self.clock[1:RUNS].copy_(self.table.counters(self.view(), self.sem, self.recomputed))
        self.clock[0:1].add_(self.one)

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
            score = self.fresca(score, self._now()).contiguous()
        noise = self.noise if self.noise is not None else self._draw_noise()
        chain_step.score_post(self.clock, self.sem, self.ts, self.step_size, self.G, score, noise,
                              self.x, self.done, self.scheduler, self.max_len)
