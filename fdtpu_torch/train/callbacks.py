"""Training-time evaluation callbacks (port of
``fdtpu/train/callbacks.py:34-171``).

* :class:`SamplingCallback`: every N epochs, sample with the current
  parameters, map the samples back to the data domain (de-standardize, then
  the inverse DFT for frequency-trained models) and log the Wasserstein
  metrics.
* :class:`DiffusionMethodComparisonCallback`: time a list of sampling methods
  (cache on or off, K/R variants, FreSca) against the first and log the
  speedups.

The trainer calls ``on_train_epoch_end(trainer=, network=, epoch=)`` with
its training network; a callback samples from a frozen copy of it.  JAX's
``PRNGKey(seed)`` becomes a generator seeded with ``seed`` on the network's
device.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import time
from typing import Any, Optional

import numpy as np
import torch

from fdtpu_torch.data.dataset import DiffusionDataset
from fdtpu_torch.metrics import MarginalWasserstein, SlicedWasserstein
from fdtpu_torch.models.score_models import ScoreModel
from fdtpu_torch.ops import idft
from fdtpu_torch.sampling import DiffusionSampler
from fdtpu_torch.utils.device import module_device


def frozen_model(template: ScoreModel, network: torch.nn.Module) -> ScoreModel:
    """``template`` with a frozen copy of ``network`` (no gradients kept)."""
    net = copy.deepcopy(network).eval().requires_grad_(False)
    for p in net.parameters():
        p.grad = None
    return dataclasses.replace(template, network=net)


def _generator(model: ScoreModel, seed: int) -> torch.Generator:
    return torch.Generator(device=module_device(model.network)).manual_seed(seed)


def to_data_domain(samples: torch.Tensor, datamodule: Any,
                   train_set: DiffusionDataset) -> np.ndarray:
    """Model-domain samples back to series: de-standardize with the train
    statistics, then the inverse DFT when the model was trained on the
    frequency representation (``cli/sample.py:139-143``)."""
    x = samples.detach().cpu().numpy()
    if datamodule.standardize:
        x = x * train_set.feature_std + train_set.feature_mean
    if datamodule.fourier_transform:
        x = idft(torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))).numpy()
    return x


class SamplingCallback:
    def __init__(
        self,
        datamodule: Any,
        model_template: ScoreModel,
        every_n_epochs: int = 10,
        sample_batch_size: int = 64,
        num_samples: int = 200,
        num_diffusion_steps: int = 1000,
        num_directions: int = 200,
        random_seed: int = 42,
    ) -> None:
        self.datamodule = datamodule
        self.model_template = model_template
        self.every_n_epochs = every_n_epochs
        self.sample_batch_size = sample_batch_size
        self.num_samples = num_samples
        self.num_diffusion_steps = num_diffusion_steps
        self.random_seed = random_seed
        x_train = datamodule.X_train
        self.train_set = DiffusionDataset(X=x_train,
                                          fourier_transform=datamodule.fourier_transform,
                                          standardize=datamodule.standardize)
        self.metrics = [
            SlicedWasserstein(original_samples=x_train, random_seed=random_seed,
                              num_directions=num_directions),
            MarginalWasserstein(original_samples=x_train, random_seed=random_seed),
        ]

    def on_train_epoch_end(self, trainer, network: torch.nn.Module, epoch: int) -> None:
        if (epoch + 1) % self.every_n_epochs != 0:
            return
        model = frozen_model(self.model_template, network)
        sampler = DiffusionSampler(model, sample_batch_size=self.sample_batch_size)
        samples = sampler.sample(self.num_samples, self.num_diffusion_steps,
                                 generator=_generator(model, self.random_seed + epoch))
        samples = to_data_domain(samples, self.datamodule, self.train_set)
        record: dict[str, Any] = {"epoch": epoch}
        for metric in self.metrics:
            record.update({f"metrics/{k}": v for k, v in metric(samples).items()
                           if not isinstance(v, list)})
        trainer._log(record)
        logging.info("SamplingCallback epoch %d: %s", epoch, record)


class DiffusionMethodComparisonCallback:
    """``methods``: dicts with ``name, num_diffusion_steps, use_cache,
    cache_kwargs, use_fresca, fresca_kwargs`` (``configs/trainer/
    diffusion_comparison.yaml``)."""

    def __init__(
        self,
        model_template: ScoreModel,
        methods: list[dict[str, Any]],
        every_n_epochs: int = 1,
        num_samples: int = 5,
        warmup_steps: int = 2,
        sample_batch_size: int = 5,
        random_seed: int = 42,
    ) -> None:
        self.model_template = model_template
        self.methods = methods
        self.every_n_epochs = every_n_epochs
        self.num_samples = num_samples
        self.warmup_steps = warmup_steps
        self.sample_batch_size = sample_batch_size
        self.random_seed = random_seed
        self.last_results: dict[str, Any] = {}

    def run(self, network: torch.nn.Module) -> dict[str, Any]:
        model = frozen_model(self.model_template, network)
        results: dict[str, Any] = {}
        baseline_time: Optional[float] = None
        for method in self.methods:
            sampler = DiffusionSampler(
                model,
                sample_batch_size=self.sample_batch_size,
                use_cache=bool(method.get("use_cache", False)),
                cache_kwargs=method.get("cache_kwargs") or {},
                use_fresca=bool(method.get("use_fresca", False)),
                **(method.get("fresca_kwargs") or {}),
            )
            steps = int(method.get("num_diffusion_steps", 10))
            # A warm-up call first, so the timing leaves out first-call costs.
            sampler.sample(1, self.warmup_steps, generator=_generator(model, 0))
            t0 = time.perf_counter()
            out = sampler.sample(self.num_samples, steps,
                                 generator=_generator(model, self.random_seed))
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            elapsed = time.perf_counter() - t0
            entry: dict[str, Any] = {"time_s": round(elapsed, 4)}
            if method.get("use_cache"):
                entry["cache_stats"] = sampler.get_cache_stats()
            if baseline_time is None:
                baseline_time = elapsed
            else:
                entry["speedup_vs_baseline"] = round(baseline_time / elapsed, 3)
            results[method["name"]] = entry
        self.last_results = results
        return results

    def on_train_epoch_end(self, trainer, network: torch.nn.Module, epoch: int) -> None:
        if (epoch + 1) % self.every_n_epochs != 0:
            return
        results = self.run(network)
        trainer._log({"epoch": epoch, "diffusion_comparison": results})
        logging.info("DiffusionMethodComparison epoch %d:\n%s", epoch,
                     json.dumps(results, indent=2))
