"""The reverse chain as replays of captured per-segment graphs
(``DiffusionSampler(batches_per_call > 1)``; the JAX package's
``_sample_batches_resident``, ``fdtpu/sampling/sampler.py:686-784``).

The JAX package scans whole trajectories in one dispatch.  Here each step is
one or two replays of graphs captured once per sampler and shape
(:class:`~fdtpu_torch.utils.graphs.GraphRunner`), with the E²-CRF decisions
still taken on the host, one device read a step at most, as in the eager
loop (:func:`~fdtpu_torch.sampling.sampler.sample_chain`):

* uncached: one graph, the forward and the Euler–Maruyama update;
* score level: the refresh (cold or warm) or the skip, after the host's
  decision;
* token level: the policy's arithmetic, then (after one read) the FULL
  (cold or warm), TOPK or SKIP step; a FULL step decided by the host
  counters runs no policy graph;
* KV level: the event policy's arithmetic (and its probe draw), then after
  one read the FULL, MIXED or CACHED forward, with or without a FreqCa ring
  entry; the macro policy decides on the host alone.

Every graph reads and writes static tensors: the sample ``x``, the cache
state's tensors (a new value is copied into them in place; FreqCa's ring
included), the policy's outputs, and a device clock ``(i, step,
last_full_step)`` that each step's graph advances, so that the time grid
``ts[i]``, injected noise ``[i]`` and the counters the arithmetic needs are
read on the device, never frozen at their capture values.  The host keeps
the cache's step counters with the same helpers as the eager loop, so the
statistics end equal.  Random draws come from the chain's own generator,
registered with every graph; it takes the caller's generator state before a
``sample()`` call and hands it back after, so the draws are the eager
loop's.

On a CPU network the same segments run directly, an eager loop with the same
values.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from fdtpu_torch.cache.e2crf import (
    MODE_FULL,
    TOKEN_FULL,
    CacheState,
    E2CRFConfig,
    PolicyParams,
    count_kv_step,
    event_mode,
    event_policy_terms,
    event_refresh_due,
    kv_ring_due,
    kv_state_update,
    macro_mode,
    score_skip_decision,
    token_mode,
    token_policy_terms,
    token_refresh_due,
)
from fdtpu_torch.diffusion.sde import SDE
from fdtpu_torch.models.score_models import ScoreNetwork, score_apply_cached
from fdtpu_torch.sampling.sampler import (
    _count_refresh,
    _count_skip,
    _count_token,
    _refresh,
    _skip,
    _token_mode_step,
)
from fdtpu_torch.utils.graphs import GraphRunner, write_back


def tensor_fields(state: CacheState) -> dict[str, torch.Tensor]:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)}


def host_fields(state: CacheState) -> dict:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if not isinstance(getattr(state, f.name), torch.Tensor)}


class GraphedChain:
    """The chain of one sampler at one batch size and step count: static
    buffers, the device clock and the segment graphs (module docstring).
    ``state`` is the cache (None uncached): its tensors are the static ones,
    its host counters those of the last step run."""

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
        device: torch.device,
        inject_steps: bool,
        inject_probes: bool,
    ) -> None:
        cfg = network.config
        self.network = network.compute_copy()
        # Every tensor a graph reads lives on the card: a capture refuses a
        # copy from the host.
        if scheduler.G is not None:
            scheduler = dataclasses.replace(scheduler, G=scheduler.G.to(device))
        self.scheduler = scheduler
        self.cfg = cache_cfg
        self.pp = pp
        self.fresca = fresca
        self.num_steps = num_steps
        self.max_len = cfg.max_len
        self.x = torch.zeros((batch, cfg.max_len, cfg.n_channels), device=device)
        self.ts, self.step_size = scheduler.timesteps(num_steps, device=device)
        # (i, step, last_full_step); each step's graph adds (1, 1, 0).
        self.clock = torch.zeros((3,), dtype=torch.int64, device=device)
        self.tick = torch.tensor([1, 1, 0], dtype=torch.int64, device=device)
        self.noise = (torch.zeros((num_steps, *self.x.shape), device=device)
                      if inject_steps else None)
        self.probes = (torch.zeros((num_steps, cfg.max_len), device=device)
                       if inject_probes else None)
        self.generator = torch.Generator(device=device)
        self.state = state
        self.tensors = tensor_fields(state) if state is not None else {}
        t = cfg.max_len
        self.flags = torch.zeros((2,), dtype=torch.int64, device=device)
        self.mask = torch.zeros((t,), dtype=torch.bool, device=device)
        self.w_drift = torch.zeros((t,), device=device)
        self.mean_drift = torch.zeros((), device=device)
        self.full_mask = torch.ones((t,), dtype=torch.bool, device=device)
        if cache_cfg is not None:
            self.low_bonus = torch.where(torch.arange(t, device=device) < pp.K, 2e9, 0.0)
        self.runner = GraphRunner.for_device(device, (self.generator,))

    # ----------------------------------------------------------- host side
    def reset(self, fresh: CacheState) -> None:
        """Take a freshly initialised state's values (in place)."""
        write_back(self.tensors, tensor_fields(fresh))
        self.state = self.state.replace(**host_fields(fresh))

    def mark_cold(self) -> None:
        """Quirk Q5's cross-batch prep, in place (``_prep_cache_for_new_batch``)."""
        self.tensors["drift_rate"].zero_()
        self.state = self.state.replace(cold=True)

    def snapshot(self) -> Optional[CacheState]:
        """The cache state with its own copies of the static tensors."""
        if self.state is None:
            return None
        return self.state.replace(**{k: v.clone() for k, v in self.tensors.items()})

    @torch.no_grad()
    def sample_batch(self, x0: torch.Tensor, step_noise: Optional[torch.Tensor] = None,
                     probe_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run one trajectory from ``x0``; returns the static sample (copy it
        before the next batch)."""
        self.x.copy_(x0)
        if self.noise is not None:
            self.noise.copy_(step_noise)
        if self.probes is not None:
            self.probes.copy_(probe_noise)
        c = self.state
        self.clock[0].fill_(0)
        if c is not None:
            self.clock[1].fill_(c.step)
            self.clock[2].fill_(c.last_full_step)
        run = self.runner.run
        level = None if self.cfg is None else self.cfg.level
        for _ in range(self.num_steps):
            if level is None:
                run("step", self._uncached)
            elif level == "score":
                self.state = self._score_step(run)
            elif level == "token":
                self.state = self._token_step(run)
            else:
                self.state = self._kv_step(run)
            if self.state is not None:
                self.state = self.state.replace(step=self.state.step + 1)
        return self.x

    def _score_step(self, run) -> CacheState:
        c = self.state
        if score_skip_decision(self.cfg, self.pp, c):
            cold = c.cold
            run(("refresh", cold), lambda: self._refresh(cold))
            return _count_refresh(c, self.max_len)
        run(("skip",), self._skip)
        return _count_skip(c, self.max_len)

    def _token_step(self, run) -> CacheState:
        c = self.state
        if token_refresh_due(self.pp, c):
            mode = TOKEN_FULL
        else:
            run(("token-policy",), self._token_policy)
            mode = token_mode(c, *self.flags.tolist())
        cold = c.cold
        run(("token", mode, cold), lambda: self._token(mode, cold))
        return _count_token(c, mode, self.cfg, self.max_len)

    def _kv_step(self, run) -> CacheState:
        c, cfg = self.state, self.cfg
        if cfg.policy == "macro":
            mode, count = macro_mode(self.pp, c, self.max_len)
        else:
            due = event_refresh_due(self.pp, c)
            # The policy graph holds the step's probe draw, which the eager
            # loop makes even on a step the counters decide.
            if cfg.resolved_random_probe_ratio > 0.0 or not due:
                run(("kv-policy",), self._kv_policy)
            if due:
                mode, count = MODE_FULL, self.max_len
            else:
                mode, count = event_mode(*self.flags.tolist(), self.max_len)
        ring = kv_ring_due(cfg, c)
        # The macro policy's MIXED mask is the first `count` tokens, a constant.
        macro = count if cfg.policy == "macro" else None
        run(("kv", mode, ring, macro), lambda: self._kv(mode, ring, macro))
        return count_kv_step(c, mode, count, self.max_len)

    # --------------------------------------------- segments (static tensors)
    def _now(self) -> tuple[torch.Tensor, torch.Tensor]:
        t = self.ts.index_select(0, self.clock[0:1]).reshape(())
        return t, t.expand(self.x.shape[0])

    def _step_noise(self) -> torch.Tensor:
        if self.noise is not None:
            return self.noise.index_select(0, self.clock[0:1])[0]
        return torch.randn(self.x.shape, generator=self.generator, device=self.x.device)

    def _probe(self) -> torch.Tensor:
        if self.probes is not None:
            return self.probes.index_select(0, self.clock[0:1])[0]
        return torch.rand((self.max_len,), generator=self.generator, device=self.x.device)

    def _since(self) -> torch.Tensor:
        return self.clock[1] - self.clock[2]

    def _finish(self, score: torch.Tensor, t: torch.Tensor,
                state: Optional[CacheState] = None) -> None:
        """The step's Euler–Maruyama update, the new cache state written
        back, the clock advanced."""
        x = self.scheduler.step(self.fresca(score, t), t, self.x, self._step_noise(),
                                self.step_size)
        if state is not None:
            write_back(self.tensors, tensor_fields(state))
        self.x.copy_(x)
        self.clock.add_(self.tick)

    def _uncached(self) -> None:
        t, t_batch = self._now()
        self._finish(self.network(self.x, t_batch), t)

    def _refresh(self, cold: bool) -> None:
        t, t_batch = self._now()
        _, std = self.scheduler.marginal_prob(self.x, t_batch)
        score, c, _ = _refresh(self.network, self.state.replace(cold=cold), self.cfg, self.pp,
                               self.x, t, t_batch, std, since=self._since())
        self.clock[2:3].copy_(self.clock[1:2])
        self._finish(score, t, c)

    def _skip(self) -> None:
        t, t_batch = self._now()
        _, std = self.scheduler.marginal_prob(self.x, t_batch)
        score, c = _skip(self.state.replace(cold=False), self.cfg, t, std, since=self._since())
        self._finish(score, t, c)

    def _token_policy(self) -> None:
        w_drift, mean_drift, flags = token_policy_terms(self.cfg, self.pp, self.state, self.x,
                                                        step=self.clock[1])
        self.w_drift.copy_(w_drift)
        self.mean_drift.copy_(mean_drift)
        self.flags.copy_(flags)

    def _token(self, mode: int, cold: bool) -> None:
        t, t_batch = self._now()
        _, std = self.scheduler.marginal_prob(self.x, t_batch)
        score, c = _token_mode_step(
            self.network, self.state.replace(cold=cold), self.cfg, self.pp, self.x, t_batch,
            std, self.low_bonus, self._probe, mode, self.w_drift, self.mean_drift,
            self.clock[1],
        )
        self._finish(score, t, c)

    def _kv_policy(self) -> None:
        probe_u = self._probe() if self.cfg.resolved_random_probe_ratio > 0.0 else None
        mask, flags = event_policy_terms(self.cfg, self.pp, self.state, self.x, probe_u)
        self.mask.copy_(mask)
        self.flags.copy_(flags)

    def _kv(self, mode: int, ring: bool, macro_count: Optional[int]) -> None:
        t, t_batch = self._now()
        if mode == MODE_FULL:
            mask = self.full_mask
        elif macro_count is not None:
            mask = torch.arange(self.max_len, device=self.x.device) < macro_count
        else:
            mask = self.mask
        c = self.state
        score, kv, crf = score_apply_cached(self.network, self.x, t_batch, (c.k, c.v), mask, mode)
        self._finish(score, t, kv_state_update(self.cfg, c, kv, crf, t, ring))
