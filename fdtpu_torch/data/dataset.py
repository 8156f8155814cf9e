"""Diffusion dataset (port of ``fdtpu/data/dataset.py:39-91``).

The DFT and the standardization statistics are computed once, at
construction, on the host (the frequency transform lives outside the
network).  The statistics are what ``cli/sample.py`` uses to de-standardize
generated samples; the batching for training comes with the training slice
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fdtpu_torch.ops.fourier import dft


def _host_dft(X: np.ndarray) -> np.ndarray:
    return dft(torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32))).numpy()


class DiffusionDataset:
    """Holds (optionally frequency-transformed, standardized) series.

    ``X_ref`` supplies the standardization statistics (a validation set is
    standardized with train-set statistics).  The std uses ddof=1 like torch
    ``Tensor.std``; a degenerate std (a single reference sample, or a
    constant feature) falls back to 1.
    """

    def __init__(
        self,
        X: np.ndarray,
        fourier_transform: bool = False,
        standardize: bool = False,
        X_ref: Optional[np.ndarray] = None,
    ) -> None:
        X = np.asarray(X, dtype=np.float32)
        if fourier_transform:
            X = _host_dft(X)
        self.X = X
        self.standardize = standardize
        if X_ref is None:
            X_ref = X
        else:
            X_ref = np.asarray(X_ref, dtype=np.float32)
            if fourier_transform:
                X_ref = _host_dft(X_ref)
        self.feature_mean = X_ref.mean(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            std = X_ref.std(axis=0, ddof=1)
        self.feature_std = np.where(np.isfinite(std) & (std > 0), std, 1.0)

    def standardized(self) -> np.ndarray:
        if not self.standardize:
            return self.X
        return (self.X - self.feature_mean) / self.feature_std
