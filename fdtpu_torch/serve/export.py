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
program's size does not grow with the step count; each step runs the
resident chain's step table (:class:`~fdtpu_torch.sampling.resident.StepTable`:
its decision, its branches, its update and counters), the decision picking
a branch through nested ``torch.cond``\\s, each branch returning the step's
score and a new cache state, which the loop carries.  What is the
program's own is what a traced program needs: the carried tensors, the
branches' outputs as contiguous copies, copies of the K/V store that the
forwards write in place, and, at the KV level with FreqCa, a ``cond``
inside each mode's branch on whether the step adds a ring entry, so that
each forward is traced once.  On the CPU the reloaded program equals the
sampler bitwise (``tests/test_torch_export.py``).  Attention goes
through the registered operators: ``fdtpu::blockdiag_mha`` (kernel B1) in
every full forward under ``attention_impl="blockdiag"``, ``fdtpu::fused_mha``
(B4) in the cached modes; every layer's FFN tail through ``fdtpu::ffn_block``
(F1); FreqCa's Hermite fit through
``fdtpu::hermite_solve`` (:mod:`fdtpu_torch.ops.fourier`, cuSOLVER pinned
inside the operator on the card), as in the sampler.  Run eagerly, the loop
reads its predicate and each ``cond`` its branch on the host every step, as
the eager loop does.

Exported levels: uncached; the score level (Taylor ε̂, every ``eps_order``,
or FreqCa's ``eps_predictor="freqca"``, guard on or off, with or without
FreSca); the token level; the KV level's event and macro policies, with or
without FreqCa's ring (``use_freqca``).  A sampler on a mesh is not exported (the program is one device's).  The JAX package's
``platforms`` choice becomes the sampler's device: the program runs where it
was exported.
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
    RING_FIELDS,
    CacheState,
    counters_of,
    init_cache_state,
    kv_ring_due,
    kv_ring_entry,
)
from fdtpu_torch.sampling.resident import StepTable, cache_tensors
from fdtpu_torch.sampling.sampler import DiffusionSampler

FORMAT = "torch.export/pt2"


def _check_exportable(sampler: DiffusionSampler) -> None:
    """Raise ``ValueError`` for a sampler on a mesh (module docstring)."""
    if sampler.mesh is not None:
        raise ValueError("a sampler on a mesh is not exported: export one without a mesh; "
                         "the program runs on one device")


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
        self.cfg = cfg
        self.level = None if cfg is None else cfg.level
        self.num_steps = num_diffusion_steps
        self.batch, self.max_len = sampler.sample_batch_size, mcfg.max_len
        self.shape = (self.batch, mcfg.max_len, mcfg.n_channels)
        self.network = sampler.score_model.network.compute_copy()
        scheduler = sampler.noise_scheduler
        if scheduler.G is not None:
            self.register_buffer("G", scheduler.G.to(device))
            scheduler = dataclasses.replace(scheduler, G=self.G)
        ts, step_size = scheduler.timesteps(num_diffusion_steps, device=device)
        self.register_buffer("ts", ts)
        self.register_buffer("step_size", step_size)
        self.table = StepTable(self.network, scheduler, cfg, sampler.policy_params,
                               sampler._fresca_fn(num_diffusion_steps), self.step_size,
                               self.batch, ring_branches=False)
        if cfg is not None:
            self.fresh_state = partial(
                init_cache_state, cfg, self.batch, mcfg.max_len, mcfg.n_channels, device,
                num_layers=mcfg.num_layers, n_head=mcfg.n_head, head_dim=mcfg.head_dim,
                d_model=mcfg.d_model, kv_dtype=mcfg._cdtype)
            self.names = list(cache_tensors(self.fresh_state()))

    # ------------------------------------------------------------ the inputs
    def input_shapes(self) -> dict[str, tuple[int, ...]]:
        """The program's inputs in call order, with their shapes."""
        shapes = {"prior_noise": self.shape,
                  "step_noise": (self.num_steps, *self.shape)}
        if self.table.draws_probe:
            shapes["probe_noise"] = (self.num_steps, self.max_len)
        return shapes

    def draws(self) -> list[dict[str, Any]]:
        """How the sampler draws each input, in its order: the prior first,
        then at every step its probe uniforms and its noise."""
        shapes = self.input_shapes()
        per_step = (["probe_noise"] if self.table.draws_probe else []) + ["step_noise"]
        return [{"name": name, "distribution": "uniform" if name == "probe_noise" else "normal",
                 "shape": list(shapes[name][1:] if name in per_step else shapes[name]),
                 "per_step": name in per_step}
                for name in ["prior_noise", *per_step]]

    def example_inputs(self) -> tuple[torch.Tensor, ...]:
        return tuple(torch.zeros(s, device=self.ts.device) for s in self.input_shapes().values())

    # --------------------------------------------------------------- the chain
    def forward(self, prior_noise: torch.Tensor, step_noise: torch.Tensor,
                probe_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        given = (prior_noise, step_noise) + ((probe_noise,) if self.table.draws_probe else ())
        for (name, shape), a in zip(self.input_shapes().items(), given):
            if a is None or tuple(a.shape) != shape:
                raise ValueError(f"{name} must be {shape}, got "
                                 f"{None if a is None else tuple(a.shape)}")
        x = self.table.scheduler.prior_sampling(prior_noise.shape, noise=prior_noise)
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

    def _step(self, step_noise, probe_noise, i, x, *carried):
        table = self.table
        t = self.ts.index_select(0, i.reshape(1)).reshape(())

        def noise():
            return step_noise.index_select(0, i.reshape(1))[0]

        if self.level is None:
            score, _ = table.forward(None, x, t)
            return i + 1, table.update(score, t, x, noise)
        counters, tensors = carried[0], carried[1:]
        c = self._view(counters, tensors)
        probe = probe_noise.index_select(0, i.reshape(1))[0] if table.draws_probe else None
        sem, branch, extra, n = table.decide(c, x, probe)
        branches = [partial(self._branch, fn, len(extra)) for _, fn in table.branches()]
        score, *tensors = _switch(branch, branches, (x, t, counters, *extra, *tensors))
        return i + 1, table.update(score, t, x, noise), table.counters(c, sem, n), *tensors

    def _branch(self, fn: Callable, n_extra: int, x, t, counters, *operands) -> tuple:
        """The table's branch ``fn`` on a ``cond``'s operands ``(x, t,
        counters, *extra, *state tensors)``, returning ``(score, *state
        tensors)``: each a contiguous copy, since a ``cond`` branch may not
        return one of its inputs (as a branch does with the state it leaves
        alone) and the branches of a ``cond`` must agree in layout (FreqCa's
        prediction comes out of the solve column-major)."""
        c = self._view(counters, operands[n_extra:])
        if self.level != "score":  # the forwards write the K/V store in place: into copies
            c = c.replace(k=c.k.clone(), v=c.v.clone())
        score, new = fn(c, x, t, *operands[:n_extra])
        if self.level == "kv" and self.cfg.use_freqca:
            new = new.replace(**self._ring(c, new.crf_prev, t))
        return tuple(a.clone(memory_format=torch.contiguous_format)
                     for a in (score, *cache_tensors(new).values()))

    def _ring(self, c: CacheState, crf: torch.Tensor, t: torch.Tensor) -> dict:
        """FreqCa's ring after the step: with the CRF's entry where it is due."""
        def entry(crf, t, *ring):
            return tuple(kv_ring_entry(self.cfg, c.replace(**dict(zip(RING_FIELDS, ring))),
                                       crf, t).values())

        def keep(crf, t, *ring):
            return tuple(a.clone() for a in ring)

        ring = torch.cond(kv_ring_due(self.cfg, c), entry, keep,
                          (crf, t, *(getattr(c, f) for f in RING_FIELDS)))
        return dict(zip(RING_FIELDS, ring))


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
