"""Load an exported sampling program (the loading half of
``fdtpu/serve/export.py``).

Needs torch and the kernels' operator registrations
(:mod:`fdtpu_torch.kernels`, which the program's attention calls) and
nothing else of the port: no model, sampler, config or checkpoint code, as
the JAX loader needs only jax.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable

import torch

# Importing the kernels registers the fdtpu:: operators that the program calls.
from fdtpu_torch.kernels import attention, blockdiag_attention, build


def _draw(spec: dict[str, Any], generator: torch.Generator, device: torch.device) -> torch.Tensor:
    draw = torch.rand if spec["distribution"] == "uniform" else torch.randn
    return draw(tuple(spec["shape"]), generator=generator, device=device)


def load_exported(path: str | Path) -> Callable[[torch.Generator], torch.Tensor]:
    """Load ``path`` (written by :func:`~fdtpu_torch.serve.export.export_sampler`)
    and its ``<path>.json`` meta; returns ``fn(generator) -> samples``.

    ``fn`` draws the program's inputs from ``generator`` on the program's
    device in the sampler's order (the meta's ``draws``: the prior, then at
    every step its probe uniforms and its noise) and runs the program, under
    ``torch.no_grad()``.  ``fn.program`` is the program itself,
    ``(prior_noise, step_noise[, probe_noise]) -> samples``; ``fn.meta`` the
    metadata.  A program for the card has its kernels built here (one
    ``nvcc`` a source, where not built yet), not inside its first step."""
    path = Path(path)
    meta = json.loads(Path(f"{path}.json").read_text())
    program = torch.export.load(path).module()
    device = torch.device(meta["platforms"][0])
    steps = int(meta["num_diffusion_steps"])
    if device.type == "cuda":
        build.build([blockdiag_attention.SOURCE, blockdiag_attention.SOURCE_BWD, attention.SOURCE])

    @torch.no_grad()
    def fn(generator: torch.Generator) -> torch.Tensor:
        drawn: dict[str, Any] = {}
        per_step = [d for d in meta["draws"] if d["per_step"]]
        for spec in meta["draws"]:
            if not spec["per_step"]:
                drawn[spec["name"]] = _draw(spec, generator, device)
        columns = {d["name"]: [] for d in per_step}
        for _ in range(steps):
            for spec in per_step:
                columns[spec["name"]].append(_draw(spec, generator, device))
        drawn.update((name, torch.stack(rows)) for name, rows in columns.items())
        return program(*(drawn[name] for name in meta["input"]))

    fn.program = program
    fn.meta = meta
    return fn
