"""Sampling cells: closed-loop calls of ``DiffusionSampler.sample``.

Set-up makes the weights from the seed, builds the program's model and
sampler as the cell's traffic file states, and makes one whole call, which
builds the kernels and captures the resident chain.  The window then makes
calls back to back until ``--seconds`` have passed, finishing the call in
flight; each call gets its own prior and step noise, drawn on the device
from the seed and the call's index, handed in as ``prior_noise`` and
``step_noise`` so that the reference can be handed the same.

The check: calls drawn from the seed among those the window made, each run
again by the plain reference (``reference/chain.py``) on the same weights
and noise, whole where the cache couples the batch's rows, on a sample of
rows drawn from the seed where it does not (uncached)."""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from portbench.common import stamp, sub_seed
from portbench.program import score_model
from portbench.reference import chain as ref_chain
from portbench.reference.model import VP, precision, score
from portbench.trace import phase
from portbench.weights import make_weights


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    def __init__(self, cell: dict, traffic: dict, config: dict, seed: int, device) -> None:
        self.cell, self.traffic, self.config = cell, traffic, config
        self.seed, self.device = seed, torch.device(device)
        self.model = config["model"]
        self.n = traffic["num_samples"]
        self.steps = traffic["num_diffusion_steps"]
        self.batch = traffic["sampler"]["sample_batch_size"]
        self.outputs: list[torch.Tensor] = []
        self.modes: list = []
        self.stats: list[dict] = []

    # ------------------------------------------------------------ inputs
    def draws(self, index) -> tuple[torch.Tensor, torch.Tensor]:
        """Call ``index``'s prior and step noise (standard normals)."""
        m = self.model
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "call", index))
        prior = torch.randn((self.n, m["max_len"], m["n_channels"]), generator=g,
                            device=self.device)
        noise = torch.randn((self.steps, self.n, m["max_len"], m["n_channels"]), generator=g,
                            device=self.device)
        return prior, noise

    # ----------------------------------------------------------- program
    def setup(self) -> None:
        from fdtpu_torch.sampling import DiffusionSampler

        self.weights = make_weights(self.model, sub_seed(self.config["weights_seed"], "weights"),
                                    self.device)
        self.program = score_model(self.config, self.weights, self.device, self.steps)
        stamp("weights and model")
        s = self.traffic["sampler"]
        self.sampler = DiffusionSampler(self.program, sample_batch_size=s["sample_batch_size"],
                                        use_cache=s["use_cache"],
                                        cache_kwargs=s.get("cache_kwargs"),
                                        batches_per_call=s["batches_per_call"])
        self.call("warm")
        _sync(self.device)
        stamp("warm-up call")
        self.outputs, self.modes, self.stats = [], [], []

    def call(self, index) -> None:
        """One call: its draws, ``sample``, and what the check and the
        counters read afterwards (kept on the device)."""
        with phase("draw"):
            prior, noise = self.draws(index)
        with phase("call"):
            x = self.sampler.sample(self.n, self.steps, prior_noise=prior, step_noise=noise)
        with phase("sync"):
            _sync(self.device)
        self.outputs.append(x)
        self.modes.append(self.sampler.last_modes)
        self.stats.append(self.sampler.get_cache_stats())

    def window(self, seconds: float) -> dict:
        from fdtpu_torch.kernels import blockdiag_attention as bda

        b1 = bda.launches
        _sync(self.device)
        t0 = time.perf_counter()
        i = 0
        while True:
            self.call(i)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        n_traj = self.n // self.batch
        total = i * n_traj * self.steps
        full = (sum(s["full_steps"] for s in self.stats) if self.stats and self.stats[0]
                else total)
        self.win = dict(wall_s=wall, calls=i, samples=i * self.n, steps=total, full_steps=full,
                        b1_launches=bda.launches - b1, rows=self.batch)
        return self.win

    def end_to_end(self, setup_s: float) -> dict:
        return {self.traffic["throughput_metric"]: {
                    "value": self.win["samples"] / self.win["wall_s"], "unit": "samples/s"},
                "setup_s": {"value": setup_s, "unit": "s"}}

    def attempted(self) -> tuple[int, int]:
        return self.win["calls"], 0

    def traced(self, profile) -> dict:
        """The traced segment: ``span_forwards`` full forwards of the network
        at the cell's batch, eagerly, after one.  The resident chain runs its
        steps inside a conditional WHILE node, whose kernels the profiler
        (CUPTI) does not report, so the chain's own calls cannot be traced;
        the forwards show the network's kernels, B1 among them, at the cell's
        shapes.  Returns the profiler, the forwards it saw, the counters the
        completeness check holds the trace to, and the shapes of the
        launches for the bounds."""
        from fdtpu_torch.kernels import blockdiag_attention as bda

        m = self.model
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "span"))
        x = torch.randn((self.batch, m["max_len"], m["n_channels"]), generator=g,
                        device=self.device)
        t = torch.rand((self.batch,), generator=g, device=self.device)
        net = self.program.network
        reps = self.traffic["span_forwards"]
        with torch.no_grad():
            net(x, t)
            before = bda.launches

            def forwards():
                with phase("forward"):
                    for _ in range(reps):
                        net(x, t)

            prof = profile(forwards)
        b1 = bda.launches - before
        return dict(profiler=prof, forwards=reps, counted={"blockdiag_mha_fwd_kernel": b1},
                    shapes={"b1": [(self.batch, m["max_len"], m["n_head"],
                                    m["d_model"] // m["n_head"], b1)]})

    # ------------------------------------------------------------- check
    def free(self) -> None:
        """Drop the program's state (the outputs and modes stay)."""
        self.outputs = [x.detach() for x in self.outputs]
        del self.sampler, self.program
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _chosen(self) -> list[int]:
        calls = self.win["calls"]
        rng = np.random.default_rng(sub_seed(self.seed, "check"))
        k = min(self.traffic["check"]["calls"], calls)
        return sorted(rng.choice(calls, size=k, replace=False).tolist())

    def _reference(self, index, follow, tf32: bool, rows=None) -> dict:
        m = self.model
        cache = (self.traffic["sampler"].get("cache_kwargs")
                 if self.traffic["sampler"]["use_cache"] else None)
        prior, noise = self.draws(index)
        batch = self.batch
        if rows is not None:  # uncached: rows are independent
            prior, noise, batch = prior[rows], noise[:, rows], len(rows)
        vp = VP(self.config["sde"], m["max_len"], self.device)
        with torch.no_grad(), precision(tf32):
            return ref_chain.run_call(lambda x, t: score(self.weights, m, x, t), vp, prior,
                                      noise, batch, cache, follow,
                                      self.traffic["check"]["band"])

    def _rows(self, index) -> list[int] | None:
        k = self.traffic["check"].get("rows")
        if k is None:
            return None
        rng = np.random.default_rng(sub_seed(self.seed, "rows", index))
        return sorted(rng.choice(self.n, size=k, replace=False).tolist())

    def check(self, control: bool = False) -> dict:
        """The compared numbers: ``sample_gap``, the widest relative L2 gap
        of a checked sample from the reference's, and ``decisions``, the
        checked steps whose cache decision differs from the reference's
        outside the rounding band.  ``control``: the reference in TF32 in the
        program's place."""
        gap, mismatched, followed = 0.0, 0, 0
        for index in self._chosen():
            rows = self._rows(index)
            if control:
                judged = self._reference(index, None, True, rows)
                x, modes = judged["samples"], judged["modes"]
            else:
                x = self.outputs[index] if rows is None else self.outputs[index][rows]
                modes = self.modes[index]
            ref = self._reference(index, None if modes is None else modes.cpu(), False, rows)
            d = torch.linalg.vector_norm((x - ref["samples"]).double().flatten(1), dim=1)
            r = torch.linalg.vector_norm(ref["samples"].double().flatten(1), dim=1)
            worst = float((d / r).max())
            gap = max(gap, worst) if math.isfinite(worst) else float("inf")
            mismatched += ref["mismatched"]
            followed += ref["followed"]
        print(f"portbench: checked calls {self._chosen()}, decisions taken from the judged run "
              f"inside the band: {followed}", file=sys.stderr, flush=True)
        return {"sample_gap": gap, "decisions": float(mismatched)}
