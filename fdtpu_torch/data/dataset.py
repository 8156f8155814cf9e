"""Diffusion dataset and its batch loader (port of
``fdtpu/data/dataset.py:39-129``).

The DFT and the standardization statistics are computed once, at
construction, on the host (the frequency transform lives outside the
network).  :class:`NumpyLoader` draws the same ``np.random.default_rng(seed)``
permutations as the JAX package's, so the two yield bit-identical batches.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from fdtpu_torch.ops.fourier import dft


def _host_dft(X: np.ndarray) -> np.ndarray:
    return dft(torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32))).numpy()


class DiffusionDataset:
    """Holds (optionally frequency-transformed, standardized) series.

    ``X_ref`` supplies the standardization statistics (a validation set is
    standardized with train-set statistics); ``y`` (labels, ECG's classes) is
    kept beside the series: an item carries it, the loader's batches do not.  The std uses ddof=1 like torch
    ``Tensor.std``; a degenerate std (a single reference sample, or a
    constant feature) falls back to 1.
    """

    def __init__(
        self,
        X: np.ndarray,
        y: Optional[np.ndarray] = None,
        fourier_transform: bool = False,
        standardize: bool = False,
        X_ref: Optional[np.ndarray] = None,
    ) -> None:
        X = np.asarray(X, dtype=np.float32)
        if fourier_transform:
            X = _host_dft(X)
        self.X = X
        self.y = None if y is None else np.asarray(y)
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

    def __len__(self) -> int:
        return len(self.X)

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        data = {"X": self.X[index]}
        if self.standardize:
            data["X"] = (data["X"] - self.feature_mean) / self.feature_std
        if self.y is not None:
            data["y"] = self.y[index]
        return data


class NumpyLoader:
    """Seeded, shuffled mini-batches of a :class:`DiffusionDataset` as numpy
    arrays; ``len = ceil(N / batch_size)`` (the last batch may be partial).
    Each iteration draws the next permutation, so epochs differ."""

    def __init__(
        self,
        dataset: DiffusionDataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._data = dataset.standardized()

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def skip_epochs(self, n: int) -> None:
        """Advance the shuffle past ``n`` epochs without building batches."""
        if self.shuffle:
            for _ in range(n):
                self._rng.permutation(len(self.dataset))

    def __iter__(self) -> Iterator[np.ndarray]:
        n = len(self.dataset)
        idx = self._rng.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n, self.batch_size):
            yield self._data[idx[start : start + self.batch_size]]
