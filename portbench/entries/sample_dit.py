"""The DiT sampling cell: closed-loop calls of ``DiffusionSampler.sample``
on the DiT score network (``reference/dit.py``), as ``entries/sample.py``
runs the transformer's.

Set-up makes the DiT weights on the device from the configuration's
``weights_seed`` (``weights_dit.py``) and builds the program's model with
``backbone="dit"``; the window, the draws and the check are the sampling
cell's, the check's reference being the score level of ``reference/chain.py``
around ``reference/dit.py``'s forward.  The traced segment: ``span_forwards``
eager forwards at the cell's batch, whose kernels the profiler also sorts by
the block's ranges (``fdtpu.dit.attention``, ``.mlp``, ``.modulation``)."""

from __future__ import annotations

import torch

from portbench import ranges
from portbench.common import stamp, sub_seed
from portbench.entries import sample
from portbench.reference import chain as ref_chain
from portbench.reference import dit
from portbench.reference.model import VP, precision
from portbench.trace import phase
from portbench.weights_dit import make_weights

RANGES = ("fdtpu.dit.attention", "fdtpu.dit.mlp", "fdtpu.dit.modulation")
MODEL_KEYS = ("n_channels", "max_len", "d_model", "num_layers", "n_head", "dim_feedforward",
              "dropout", "ln_eps", "backbone", "attention_impl", "compute_dtype")


def score_model(config: dict, weights: dict, device, num_training_steps: int):
    """The program's DiT model of ``config`` on ``device``, its network
    holding ``weights``."""
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model

    m, sde = config["model"], config["sde"]
    cfg = ScoreModelConfig(**{k: m[k] for k in MODEL_KEYS})
    net = init_score_model(cfg, device=device)
    net.load_state_dict(weights)
    scheduler = VPScheduler(fourier_noise_scaling=sde["fourier_noise_scaling"], eps=sde["eps"],
                            beta_min=sde["beta_min"], beta_max=sde["beta_max"])
    return ScoreModel(config=cfg, network=net,
                      scheduler=scheduler.with_noise_scaling(m["max_len"], device),
                      num_training_steps=num_training_steps)


class Cell(sample.Cell):
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
        sample._sync(self.device)
        stamp("warm-up call")
        self.outputs, self.modes, self.stats = [], [], []

    def traced(self, profile) -> dict:
        """``span_forwards`` eager forwards at the cell's batch, after one
        (``entries/sample.py``); also each DiT range's device seconds."""
        m = self.model
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "span"))
        x = torch.randn((self.batch, m["max_len"], m["n_channels"]), generator=g,
                        device=self.device)
        t = torch.rand((self.batch,), generator=g, device=self.device)
        net = self.program.network
        reps = self.traffic["span_forwards"]
        with torch.no_grad():
            net(x, t)

            def forwards():
                with phase("forward"):
                    for _ in range(reps):
                        net(x, t)

            prof = profile(forwards)
        found = {}
        if self.device.type == "cuda":
            by_range = ranges.device_seconds(prof, RANGES)
            found = {name: by_range.get(name, 0.0) for name in RANGES}
        return dict(profiler=prof, forwards=reps, counted={},
                    ranges=found if any(found.values()) else {})

    def _reference(self, index, follow, tf32: bool, rows=None) -> dict:
        m = self.model
        prior, noise = self.draws(index)
        vp = VP(self.config["sde"], m["max_len"], self.device)
        with torch.no_grad(), precision(tf32):
            return ref_chain.run_call(lambda x, t: dit.score(self.weights, m, x, t), vp, prior,
                                      noise, self.batch, self.traffic["sampler"]["cache_kwargs"],
                                      follow, self.traffic["check"]["band"])
