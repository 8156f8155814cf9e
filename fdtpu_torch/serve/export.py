"""Export of the sampling program for serving (port of ``fdtpu/serve/export.py``).

The JAX package exports the whole reverse chain (cached or not) with the
weights baked in as one StableHLO program (``jax.export``).  The port's
counterpart is ``torch.export``: :func:`export_sampler` traces
:class:`SamplingProgram` into an ``ExportedProgram``, writes it with
``torch.export.save`` and its metadata beside it as ``<path>.json``.  The
program runs without the model code, the config or the checkpoint:
:func:`~fdtpu_torch.serve.load.load_exported` needs torch and the kernels'
operator registrations (:mod:`fdtpu_torch.kernels`) only.

Contract, with the same values as the first batch of
``DiffusionSampler.sample(batch, steps, generator=g)`` (fresh cache)::

    fn(g: torch.Generator) -> float32[batch, max_len, n_channels]
    fn.program(prior_noise, step_noise[, probe_noise]) -> the same

Torch's Philox streams cannot live inside a traced program, and JAX's
threefry key has no torch counterpart, so the program's inputs are the draws
themselves: the prior noise ``(B, T, C)``, each step's noise ``(steps, B, T,
C)`` and, where the level draws them (token level; KV event level with
probes), each step's probe uniforms ``(steps, T)``.  ``fn`` draws them from
its generator in the order the sampler does (the meta's ``draws``).

The chain is functional.  One ``while_loop`` runs the steps, so the
program's size does not grow with the step count; each step's E²-CRF
decision picks one of the resident chain's branches
(:mod:`fdtpu_torch.sampling.resident`) through nested ``torch.cond``\\s, and
each branch returns the step's score and a new cache state instead of
writing in place.  The decisions are :mod:`fdtpu_torch.cache.e2crf`'s
functions, the branches the sampler's own step arithmetic
(:mod:`fdtpu_torch.sampling.sampler`), so on the CPU the reloaded program
equals the sampler bitwise (``tests/test_torch_export.py``).  Attention goes
through the registered operators: ``fdtpu::blockdiag_mha`` (kernel B1) in
every full forward under ``attention_impl="blockdiag"``, ``fdtpu::fused_mha``
(B4) in the cached modes.  Run eagerly, the loop reads its predicate and each
``cond`` its branch on the host every step, as the eager loop does.

Exported levels: uncached; the score level (Taylor ε̂, every ``eps_order``,
guard on or off, with or without FreSca); the token level; the KV level's
event and macro policies.  FreqCa (``eps_predictor="freqca"``, ``use_freqca``)
raises ``NotImplementedError``: its solve pins cuSOLVER with a global
setting (``ops/fourier.py`` ``_cusolver``) that a traced program does not
keep (ROADMAP.md).  The JAX package's ``platforms`` choice becomes the
sampler's device: the program runs where it was exported.
"""

from __future__ import annotations

import dataclasses
import json
from functools import partial
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn
from torch._higher_order_ops import while_loop

from fdtpu_torch.cache.e2crf import (
    COUNTERS,
    MODE_CACHED,
    MODE_FULL,
    MODE_MIXED,
    TOKEN_FULL,
    TOKEN_SKIP,
    TOKEN_TOPK,
    CacheState,
    count_mode,
    counters_of,
    event_policy,
    init_cache_state,
    kv_state_update,
    macro_policy,
    score_skip_decision,
    token_policy,
)
from fdtpu_torch.models.score_models import score_apply_cached
from fdtpu_torch.sampling.resident import TOKEN_COLD_FULL, cache_tensors
from fdtpu_torch.sampling.sampler import DiffusionSampler, _refresh, _skip, _token_mode_step

FORMAT = "torch.export/pt2"


def _check_exportable(sampler: DiffusionSampler) -> None:
    """Raise ``NotImplementedError`` for a sampler whose chain is not
    exported yet (module docstring)."""
    cfg = sampler.cache_config
    if cfg is not None and (cfg.eps_predictor == "freqca" or cfg.use_freqca):
        raise NotImplementedError(
            "FreqCa is not exported yet: its solve pins cuSOLVER with a global setting "
            "that a traced program does not keep (ROADMAP.md, A.3)")


def _switch(index: torch.Tensor, branches: Sequence[Callable], operands: tuple,
            first: int = 0) -> tuple:
    """``branches[index](*operands)`` as nested ``torch.cond``\\s (a ``cond``
    takes two branches)."""
    if len(branches) == 1:
        return branches[0](*operands)

    def rest(*ops):
        return _switch(index, branches[1:], ops, first + 1)

    return torch.cond(index == first, branches[0], rest, operands)


class SamplingProgram(nn.Module):
    """The first batch of ``sampler.sample(batch, num_diffusion_steps)`` as a
    functional module (module docstring): ``forward(prior_noise, step_noise[,
    probe_noise]) -> samples``.  The network's parameters and buffers are its
    own, so constants of an exported program."""

    def __init__(self, sampler: DiffusionSampler, num_diffusion_steps: int) -> None:
        super().__init__()
        _check_exportable(sampler)
        mcfg = sampler.score_model.config
        cfg = sampler.cache_config
        device = sampler.device
        self.cfg, self.pp = cfg, sampler.policy_params
        self.level = None if cfg is None else cfg.level
        self.num_steps = num_diffusion_steps
        self.batch, self.max_len = sampler.sample_batch_size, mcfg.max_len
        self.shape = (self.batch, mcfg.max_len, mcfg.n_channels)
        self.network = sampler.score_model.network.compute_copy()
        scheduler = sampler.noise_scheduler
        if scheduler.G is not None:
            self.register_buffer("G", scheduler.G.to(device))
            scheduler = dataclasses.replace(scheduler, G=self.G)
        self.scheduler = scheduler
        ts, step_size = scheduler.timesteps(num_diffusion_steps, device=device)
        self.register_buffer("ts", ts)
        self.register_buffer("step_size", step_size)
        self.fresca = sampler._fresca_fn(num_diffusion_steps)
        self.draws_probe = self.level == "token" or (
            self.level == "kv" and cfg.policy == "event"
            and cfg.resolved_random_probe_ratio > 0.0)
        if cfg is not None:
            self.fresh_state = partial(
                init_cache_state, cfg, self.batch, mcfg.max_len, mcfg.n_channels, device,
                num_layers=mcfg.num_layers, n_head=mcfg.n_head, head_dim=mcfg.head_dim,
                d_model=mcfg.d_model, kv_dtype=mcfg._cdtype)
            self.names = list(cache_tensors(self.fresh_state()))
            self.register_buffer("low_bonus", torch.where(
                torch.arange(mcfg.max_len, device=device) < self.pp.K, 2e9, 0.0))

    # ------------------------------------------------------------ the inputs
    def input_shapes(self) -> dict[str, tuple[int, ...]]:
        """The program's inputs in call order, with their shapes."""
        shapes = {"prior_noise": self.shape,
                  "step_noise": (self.num_steps, *self.shape)}
        if self.draws_probe:
            shapes["probe_noise"] = (self.num_steps, self.max_len)
        return shapes

    def draws(self) -> list[dict[str, Any]]:
        """How the sampler draws each input, in its order: the prior first,
        then at every step its probe uniforms and its noise."""
        shapes = self.input_shapes()
        per_step = (["probe_noise"] if self.draws_probe else []) + ["step_noise"]
        return [{"name": name, "distribution": "uniform" if name == "probe_noise" else "normal",
                 "shape": list(shapes[name][1:] if name in per_step else shapes[name]),
                 "per_step": name in per_step}
                for name in ["prior_noise", *per_step]]

    def example_inputs(self) -> tuple[torch.Tensor, ...]:
        return tuple(torch.zeros(s, device=self.ts.device) for s in self.input_shapes().values())

    # --------------------------------------------------------------- the chain
    def forward(self, prior_noise: torch.Tensor, step_noise: torch.Tensor,
                probe_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        given = (prior_noise, step_noise) + ((probe_noise,) if self.draws_probe else ())
        for (name, shape), a in zip(self.input_shapes().items(), given):
            if a is None or tuple(a.shape) != shape:
                raise ValueError(f"{name} must be {shape}, got "
                                 f"{None if a is None else tuple(a.shape)}")
        x = self.scheduler.prior_sampling(prior_noise.shape, noise=prior_noise)
        i = torch.zeros((), dtype=torch.int64, device=x.device)
        carried = (i, x)
        if self.level is not None:
            state = self.fresh_state()
            carried += (counters_of(state, x.device), *cache_tensors(state).values())
        out = while_loop(lambda i, *_: i < self.num_steps,
                         partial(self._step, step_noise, probe_noise), carried)
        return out[1]

    def _view(self, counters: torch.Tensor, tensors: Sequence[torch.Tensor]) -> CacheState:
        """The cache state on the carried tensors, counters as 0-d views."""
        return CacheState(**dict(zip(self.names, tensors)),
                          **{n: counters[j] for j, n in enumerate(COUNTERS)})

    @staticmethod
    def _out(score: torch.Tensor, c: CacheState) -> tuple:
        """A branch's outputs, each a copy: a ``cond`` branch may not return
        one of its inputs, as a branch does with the state it leaves alone."""
        return tuple(a.clone() for a in (score, *cache_tensors(c).values()))

    def _step(self, step_noise, probe_noise, i, x, *carried):
        t = self.ts.index_select(0, i.reshape(1)).reshape(())
        noise = step_noise.index_select(0, i.reshape(1))[0]
        if self.level is None:
            score = self.network(x, t.expand(self.batch))
            return i + 1, self._update(score, t, x, noise)
        counters, tensors = carried[0], carried[1:]
        c = self._view(counters, tensors)
        probe = probe_noise.index_select(0, i.reshape(1))[0] if self.draws_probe else None
        sem, branch, extra, n = getattr(self, f"_{self.level}_decision")(c, x, probe)
        score, *tensors = _switch(branch, self._branches(), (x, t, counters, *extra, *tensors))
        x = self._update(score, t, x, noise)
        c = count_mode(c, self.level, sem, self.max_len, n)
        c = c.replace(step=c.step + 1)
        return i + 1, x, torch.stack([getattr(c, k) for k in COUNTERS]), *tensors

    def _update(self, score, t, x, noise):
        """FreSca and the Euler–Maruyama update (the chain's ``post``)."""
        return self.scheduler.step(self.fresca(score, t), t, x, noise, self.step_size)

    def _branches(self) -> list[Callable]:
        if self.level == "score":
            return [self._skip, partial(self._refresh, False), partial(self._refresh, True)]
        if self.level == "token":
            return [partial(self._token, mode, cold) for mode, cold in (
                (TOKEN_FULL, False), (TOKEN_TOPK, False), (TOKEN_SKIP, False), (TOKEN_FULL, True))]
        return [partial(self._kv, mode) for mode in (MODE_FULL, MODE_MIXED, MODE_CACHED)]

    # ---------------------------------------------------- decisions, branches
    # Each decision returns (the step's mode, its branch, the branches' extra
    # operands, the recomputed count of count_mode); each branch takes
    # (x, t, counters, *extra, *state tensors) and returns (score, *state tensors).
    def _score_decision(self, c, x, probe):
        compute = score_skip_decision(self.cfg, self.pp, c)
        return compute, compute * (1 + c.cold), (), None

    def _token_decision(self, c, x, probe):
        mode, w_drift, mean_drift = token_policy(self.cfg, self.pp, c, x)
        cold_full = (mode == TOKEN_FULL) & (c.cold != 0)
        n = min(int(self.cfg.token_budget), self.max_len)
        return (mode, torch.where(cold_full, TOKEN_COLD_FULL, mode), (probe, w_drift, mean_drift),
                n)

    def _kv_decision(self, c, x, probe):
        if self.cfg.policy == "macro":
            mode, mask, count = macro_policy(self.pp, c, self.max_len)
        else:
            mode, mask, count = event_policy(self.cfg, self.pp, c, x, probe)
        return mode, mode, (mask,), count

    def _std(self, x, t):
        t_batch = t.expand(self.batch)
        return t_batch, self.scheduler.marginal_prob(x, t_batch)[1]

    def _skip(self, x, t, counters, *tensors):
        c = self._view(counters, tensors)
        _, std = self._std(x, t)
        score, c = _skip(c.replace(cold=False), self.cfg, t, std, counters[0] - counters[1])
        return self._out(score, c)

    def _refresh(self, cold, x, t, counters, *tensors):
        c = self._view(counters, tensors)
        t_batch, std = self._std(x, t)
        score, c, _ = _refresh(self.network, c.replace(cold=cold), self.cfg, self.pp, x, t,
                               t_batch, std, counters[0] - counters[1])
        return self._out(score, c)

    def _token(self, mode, cold, x, t, counters, probe, w_drift, mean_drift, *tensors):
        c = self._view(counters, tensors)
        t_batch, std = self._std(x, t)
        # The forwards write the K/V store in place: into copies, here.
        c = c.replace(cold=cold, k=c.k.clone(), v=c.v.clone())
        score, c = _token_mode_step(self.network, c, self.cfg, self.pp, x, t_batch, std,
                                    self.low_bonus, probe, mode, w_drift, mean_drift, c.step)
        return self._out(score, c)

    def _kv(self, mode, x, t, counters, mask, *tensors):
        c = self._view(counters, tensors)
        t_batch, _ = self._std(x, t)
        score, kv, crf = score_apply_cached(self.network, x, t_batch,
                                            (c.k.clone(), c.v.clone()), mask, mode)
        c = kv_state_update(self.cfg, c, kv, crf, t, False)
        return self._out(score, c)


def make_sampling_fn(sampler: DiffusionSampler, num_diffusion_steps: int) -> SamplingProgram:
    """The sampler's first batch as a functional module (:class:`SamplingProgram`),
    the network's weights its constants."""
    return SamplingProgram(sampler, num_diffusion_steps)


def export_sampler(
    sampler: DiffusionSampler,
    num_diffusion_steps: int,
    path: str | Path,
    platforms: Optional[list[str]] = None,
) -> dict[str, Any]:
    """Export the sampling program to ``path`` (``torch.export.save``) and
    its metadata to ``<path>.json``; returns the metadata.

    The program is traced under ``torch.no_grad()`` on the sampler's device,
    and runs there: ``platforms`` other than ``[<that device's type>]``
    raises."""
    path = Path(path)
    platform = sampler.device.type
    if platforms is not None and list(platforms) != [platform]:
        raise ValueError(f"platforms {list(platforms)}: the sampler's network is on "
                         f"{platform}, and the program runs where it was exported")
    program = make_sampling_fn(sampler, num_diffusion_steps)
    with torch.no_grad():
        exported = torch.export.export(program, program.example_inputs())
    # The artifact keeps the graph and the weights.  Not the example inputs
    # (zeros of the draws' shapes: 96 MB of step noise at the flagship's
    # T = 1000), nor each node's Python stack trace (debugging metadata,
    # most of the serialized graph).
    exported.example_inputs = None
    for module in exported.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in module.graph.nodes:
                node.meta.pop("stack_trace", None)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, path)

    cfg = sampler.score_model.config
    cache = sampler.cache_config
    meta: dict[str, Any] = {
        "format": FORMAT,
        "calling_convention": f"torch {torch.__version__}",
        "platforms": [platform],
        "input": {name: f"float32[{', '.join(map(str, shape))}]"
                  for name, shape in program.input_shapes().items()},
        "output": {
            "samples": (
                f"float32[{sampler.sample_batch_size}, {cfg.max_len}, {cfg.n_channels}]"
            )
        },
        "num_diffusion_steps": num_diffusion_steps,
        "sample_batch_size": sampler.sample_batch_size,
        "model": {
            "d_model": cfg.d_model,
            "num_layers": cfg.num_layers,
            "n_head": cfg.n_head,
            "max_len": cfg.max_len,
            "n_channels": cfg.n_channels,
            "backbone": cfg.backbone,
        },
        "use_cache": sampler.use_cache,
        "cache_kwargs": (
            {"level": cache.level, "policy": cache.policy, "R": cache.R, "tau_0": cache.tau_0}
            if sampler.use_cache
            else None
        ),
        "draws": program.draws(),
    }
    Path(f"{path}.json").write_text(json.dumps(meta, indent=2))
    return meta
