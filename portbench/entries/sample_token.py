"""The token-level sampling cell: closed-loop calls of
``DiffusionSampler.sample`` at the E²-CRF token level, as
``entries/sample.py`` runs the score level's.

Each call is handed its probe uniforms too, drawn on the device from the
seed and the call's index, so that the reference can be handed the same,
and each call's TOPK rows (``last_rows``) are kept with its samples and
modes.  On a card the set-up makes ``warm_calls`` calls after the first: a
process's first calls run slower there.  The check: each checked call run
again by ``reference/token_chain.py`` on the same weights and draws,
following the judged modes and rows inside the band.  The traced
segment: ``span_topk`` eager TOPK forwards at the cell's batch and budget
against a store of every token (after a full forward that fills it), so that
B4's launches are counted and timed."""

from __future__ import annotations

import math
import sys

import torch

from portbench.common import BenchError, stamp, sub_seed
from portbench.entries import sample
from portbench.reference import token_chain
from portbench.reference.model import VP, precision
from portbench.trace import phase

B4 = "fused_mha_f32_kernel"


class Cell(sample.Cell):
    def __init__(self, *args) -> None:
        super().__init__(*args)
        self.rows: list = []
        self.budget = min(self.traffic["sampler"]["cache_kwargs"]["token_budget"],
                          self.model["max_len"])

    def setup(self) -> None:
        super().setup()
        if getattr(self.sampler, "last_rows", None) is None:
            raise BenchError("this program's DiffusionSampler does not hand back the TOPK "
                             "rows (last_rows), which the check follows")
        if self.device.type == "cuda":
            # Timed one by one, a process's first 0-14 calls run ~7% slower
            # on the card (cause open): they are made before the window.
            for _ in range(self.traffic["warm_calls"]):
                self.call("warm")
            stamp("warm calls")
        self.outputs, self.modes, self.stats, self.rows = [], [], [], []

    def probes(self, index) -> torch.Tensor:
        """Call ``index``'s probe uniforms, (batches, steps, T)."""
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "probes", index))
        return torch.rand((self.n // self.batch, self.steps, self.model["max_len"]),
                          generator=g, device=self.device)

    def call(self, index) -> None:
        sampler = self.sampler
        with phase("draw"):
            prior, noise = self.draws(index)
            probes = self.probes(index)
        with phase("call"):
            x = sampler.sample(self.n, self.steps, prior_noise=prior, step_noise=noise,
                               probe_noise=probes)
        with phase("sync"):
            sample._sync(self.device)
        self.outputs.append(x)
        self.modes.append(sampler.last_modes)
        self.rows.append(getattr(sampler, "last_rows", None))
        self.stats.append(sampler.get_cache_stats())

    def traced(self, profile) -> dict:
        """``span_topk`` eager TOPK forwards (``score_apply_topk``) at the
        cell's batch and budget, after a full forward that fills the K/V
        store; the rows are drawn from the seed."""
        from fdtpu_torch.kernels import attention as mha
        from fdtpu_torch.models import MODE_FULL, score_apply_cached, score_apply_topk

        m = self.model
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "span"))
        x = torch.randn((self.batch, m["max_len"], m["n_channels"]), generator=g,
                        device=self.device)
        t = torch.rand((self.batch,), generator=g, device=self.device)
        idx = torch.randperm(m["max_len"], generator=g, device=self.device)[:self.budget]
        net = self.program.network
        dh = m["d_model"] // m["n_head"]
        store = tuple(torch.zeros((m["num_layers"], self.batch, m["max_len"], m["n_head"], dh),
                                  device=self.device) for _ in range(2))
        reps = self.traffic["span_topk"]
        with torch.no_grad():
            score_apply_cached(net, x, t, store, None, MODE_FULL)
            score_apply_topk(net, x, t, store, idx)
            before = mha.launches

            def steps():
                with phase("topk"):
                    for _ in range(reps):
                        score_apply_topk(net, x, t, store, idx)

            prof = profile(steps)
        b4 = mha.launches - before
        return dict(profiler=prof, forwards=reps,
                    counted={B4: b4} if self.device.type == "cuda" else {},
                    expected={B4: reps * m["num_layers"]},
                    shapes={"b4": [(self.batch, self.budget, m["n_head"], dh, m["max_len"],
                                    b4)]})

    def _reference(self, index, follow, rows, tf32: bool) -> dict:
        m = self.model
        prior, noise = self.draws(index)
        vp = VP(self.config["sde"], m["max_len"], self.device)
        with torch.no_grad(), precision(tf32):
            return token_chain.run_call(self.weights, m, vp, prior, noise, self.probes(index),
                                        self.batch, self.traffic["sampler"]["cache_kwargs"],
                                        follow, rows, self.traffic["check"]["band"])

    def check(self, control: bool = False) -> dict:
        """``sample_gap`` and ``decisions`` as the score level's
        (``entries/sample.py``), and ``rows``: the judged TOPK rows outside
        the reference's own where no priority at the budget's edge lay within
        the band.  ``control``: the reference in TF32 in the program's place."""
        gap, mismatched, rows_mismatched, followed = 0.0, 0, 0, 0
        for index in self._chosen():
            if control:
                judged = self._reference(index, None, None, True)
                x, modes, rows = judged["samples"], judged["modes"], judged["rows"]
            else:
                x, modes, rows = (self.outputs[index], self.modes[index].cpu(),
                                  self.rows[index].cpu())
            ref = self._reference(index, modes, rows, False)
            d = torch.linalg.vector_norm((x - ref["samples"]).double().flatten(1), dim=1)
            r = torch.linalg.vector_norm(ref["samples"].double().flatten(1), dim=1)
            worst = float((d / r).max())
            gap = max(gap, worst) if math.isfinite(worst) else float("inf")
            mismatched += ref["mismatched"]
            rows_mismatched += ref["rows_mismatched"]
            followed += ref["followed"] + ref["rows_followed"]
        print(f"portbench: checked calls {self._chosen()}, decisions and rows taken from the "
              f"judged run inside the band: {followed}", file=sys.stderr, flush=True)
        return {"sample_gap": gap, "decisions": float(mismatched),
                "rows": float(rows_mismatched)}
