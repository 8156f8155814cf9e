"""Sample-quality metrics (port of ``fdtpu/metrics/metrics.py:22-226``).

``MetricCollection`` evaluates each metric in the time domain and in the
frequency domain (the packed DFT of both the original and the generated
samples), with an optional spectral-density marginal Wasserstein and the
self-split and mean-only dummy baselines, key for key as the JAX package.
The distances are numpy; the DFTs go through the port's own ``dft`` and
``spectral_density`` on float32 CPU tensors.  Samples may be numpy arrays or
torch tensors on any device.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from functools import partial
from typing import Any

import numpy as np
import torch

from fdtpu_torch.metrics.wasserstein import WassersteinDistances
from fdtpu_torch.ops import dft, spectral_density


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float64).numpy()
    return np.asarray(x)


def check_flat_array(x) -> np.ndarray:
    """To float64 numpy, flattened to 2-D ``(N, T·C)``."""
    x = _to_numpy(x)
    assert x.ndim in (2, 3)
    if x.ndim == 3:
        x = x.reshape(x.shape[0], -1)
    return x.astype(np.float64)


def _dft_np(x) -> np.ndarray:
    return dft(torch.as_tensor(_to_numpy(x), dtype=torch.float32)).numpy()


def _spectral_np(x) -> np.ndarray:
    return spectral_density(torch.as_tensor(_to_numpy(x), dtype=torch.float32)).numpy()


class Metric(ABC):
    def __init__(self, original_samples) -> None:
        self.original_samples = check_flat_array(original_samples)

    @abstractmethod
    def __call__(self, other_samples) -> dict[str, Any]: ...

    @property
    @abstractmethod
    def name(self) -> str: ...

    @property
    def baseline_metrics(self) -> dict[str, float]:
        return {}


class SlicedWasserstein(Metric):
    """Sliced W₂ over random directions (reference metrics.py:100-158)."""

    def __init__(
        self,
        original_samples,
        random_seed: int,
        num_directions: int,
        save_all_distances: bool = False,
    ) -> None:
        super().__init__(original_samples)
        self.random_seed = random_seed
        self.num_directions = num_directions
        self.save_all_distances = save_all_distances

    def __call__(self, other_samples) -> dict[str, Any]:
        wd = WassersteinDistances(
            original_data=self.original_samples,
            other_data=check_flat_array(other_samples),
            seed=self.random_seed,
        )
        distances = wd.sliced_distances(self.num_directions)
        metrics: dict[str, Any] = {
            "sliced_wasserstein_mean": float(np.mean(distances)),
            "sliced_wasserstein_max": float(np.max(distances)),
        }
        if self.save_all_distances:
            metrics["sliced_wasserstein_all"] = distances.tolist()
        return metrics

    @property
    def baseline_metrics(self) -> dict[str, float]:
        n = self.original_samples.shape[0]
        wd_self = WassersteinDistances(
            self.original_samples[: n // 2],
            self.original_samples[n // 2 :],
            seed=self.random_seed,
        )
        d_self = wd_self.sliced_distances(self.num_directions)
        avg = np.mean(self.original_samples, axis=0, keepdims=True)
        wd_dummy = WassersteinDistances(
            self.original_samples, avg, seed=self.random_seed
        )
        d_dummy = wd_dummy.sliced_distances(self.num_directions)
        return {
            "sliced_wasserstein_mean_self": float(np.mean(d_self)),
            "sliced_wasserstein_max_self": float(np.max(d_self)),
            "sliced_wasserstein_mean_dummy": float(np.mean(d_dummy)),
            "sliced_wasserstein_max_dummy": float(np.max(d_dummy)),
        }

    @property
    def name(self) -> str:
        return "sliced_wasserstein"


class MarginalWasserstein(Metric):
    """Per-feature W₂ (reference metrics.py:161-217)."""

    def __init__(
        self, original_samples, random_seed: int, save_all_distances: bool = False
    ) -> None:
        super().__init__(original_samples)
        self.random_seed = random_seed
        self.save_all_distances = save_all_distances

    def __call__(self, other_samples) -> dict[str, Any]:
        wd = WassersteinDistances(
            original_data=self.original_samples,
            other_data=check_flat_array(other_samples),
            seed=self.random_seed,
        )
        distances = wd.marginal_distances()
        metrics: dict[str, Any] = {
            "marginal_wasserstein_mean": float(np.mean(distances)),
            "marginal_wasserstein_max": float(np.max(distances)),
        }
        if self.save_all_distances:
            metrics["marginal_wasserstein_all"] = distances.tolist()
        return metrics

    @property
    def baseline_metrics(self) -> dict[str, float]:
        n = self.original_samples.shape[0]
        wd_self = WassersteinDistances(
            self.original_samples[: n // 2],
            self.original_samples[n // 2 :],
            seed=self.random_seed,
        )
        d_self = wd_self.marginal_distances()
        avg = np.mean(self.original_samples, axis=0, keepdims=True)
        wd_dummy = WassersteinDistances(
            self.original_samples, avg, seed=self.random_seed
        )
        d_dummy = wd_dummy.marginal_distances()
        return {
            "marginal_wasserstein_mean_self": float(np.mean(d_self)),
            "marginal_wasserstein_max_self": float(np.max(d_self)),
            "marginal_wasserstein_mean_dummy": float(np.mean(d_dummy)),
            "marginal_wasserstein_max_dummy": float(np.max(d_dummy)),
        }

    @property
    def name(self) -> str:
        return "marginal_wasserstein"


class MetricCollection:
    """Time + frequency (+ spectral) evaluation (reference metrics.py:28-97).

    ``metrics`` entries may be `functools.partial` factories missing only
    ``original_samples`` — the reference's Hydra `_partial_` pattern.
    """

    def __init__(
        self,
        metrics: list,
        original_samples=None,
        include_baselines: bool = True,
        include_spectral_density: bool = False,
    ) -> None:
        metrics_time: list[Metric] = []
        metrics_freq: list[Metric] = []
        original_freq = _dft_np(original_samples) if original_samples is not None else None
        for metric in metrics:
            if isinstance(metric, partial):
                assert original_samples is not None
                metrics_time.append(metric(original_samples=original_samples))
                metrics_freq.append(metric(original_samples=original_freq))
            else:
                metrics_time.append(metric)
        self.metrics_time = metrics_time
        self.metrics_freq = metrics_freq
        self.include_baselines = include_baselines
        self.metric_spectral = (
            MarginalWasserstein(
                original_samples=_spectral_np(original_samples),
                random_seed=42,
                save_all_distances=True,
            )
            if include_spectral_density
            else None
        )

    def __call__(self, other_samples) -> dict[str, Any]:
        metric_dict: dict[str, Any] = {}
        other_freq = _dft_np(other_samples)
        for m_time, m_freq in zip(self.metrics_time, self.metrics_freq):
            metric_dict.update({f"time_{k}": v for k, v in m_time(other_samples).items()})
            metric_dict.update({f"freq_{k}": v for k, v in m_freq(other_freq).items()})
        if self.include_baselines:
            metric_dict.update(self.baseline_metrics)
        if self.metric_spectral is not None:
            metric_dict.update(
                {
                    f"spectral_{k}": v
                    for k, v in self.metric_spectral(_spectral_np(other_samples)).items()
                }
            )
        return dict(sorted(metric_dict.items(), key=lambda item: item[0]))

    @property
    def baseline_metrics(self) -> dict[str, float]:
        metric_dict: dict[str, float] = {}
        for m_time, m_freq in zip(self.metrics_time, self.metrics_freq):
            metric_dict.update(
                {f"time_{k}": v for k, v in m_time.baseline_metrics.items()}
            )
            metric_dict.update(
                {f"freq_{k}": v for k, v in m_freq.baseline_metrics.items()}
            )
        return metric_dict
