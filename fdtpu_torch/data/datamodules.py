"""Synthetic datamodule (port of ``fdtpu/data/datamodules.py:226-334``).

``sin(t·f + φ)`` with ``f ~ Beta(2, 2)`` and ``φ ~ N(0, 1)`` drawn from a
seeded ``numpy`` generator: the generated arrays are bit-identical to the JAX
package's.  The JAX package stores univariate data as CSV through pandas;
the port stores float32 ``.npy`` files for every channel count (the values
round-trip exactly either way).  The loaders follow the JAX base datamodule
(``fdtpu/data/datamodules.py:104-154``): a shuffled train loader seeded with
``random_seed``, a val loader over the test split standardized with the
train statistics, an unstandardized test loader.  The other datamodules are
still to port (ROADMAP.md).
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Optional

import numpy as np

from fdtpu_torch.data.dataset import DiffusionDataset, NumpyLoader


class SyntheticDatamodule:
    """Lifecycle ``prepare_data`` (generate, or regenerate when the stored
    parameters differ) → ``setup`` (load) → datasets."""

    def __init__(
        self,
        data_dir: Path | str,
        random_seed: int = 42,
        batch_size: int = 32,
        fourier_transform: bool = False,
        standardize: bool = False,
        max_len: int = 100,
        num_samples: int = 1000,
        n_channels: int = 1,
    ) -> None:
        self.n_channels = n_channels
        self.data_dir = Path(data_dir) / self.dataset_name
        self.random_seed = random_seed
        self.batch_size = batch_size
        self.fourier_transform = fourier_transform
        self.standardize = standardize
        self.max_len = max_len
        self.num_samples = num_samples
        self.X_train: np.ndarray = np.zeros((0, 0, 0), np.float32)
        self.X_test: np.ndarray = np.zeros((0, 0, 0), np.float32)

    @property
    def dataset_name(self) -> str:
        return "synthetic" if self.n_channels == 1 else f"synthetic_c{self.n_channels}"

    def _generation_params(self) -> dict[str, int]:
        return {
            "max_len": self.max_len,
            "num_samples": self.num_samples,
            "n_channels": self.n_channels,
            "random_seed": self.random_seed,
        }

    def prepare_data(self) -> None:
        """Generate — or regenerate when ``synthetic_meta.json`` records
        other generation parameters (a stale cache must never be served)."""
        meta_path = self.data_dir / "synthetic_meta.json"
        params = self._generation_params()
        if self.data_dir.exists():
            try:
                if json.loads(meta_path.read_text()) == params:
                    return
            except (OSError, ValueError):
                pass
            logging.info("Synthetic data in %s does not match %s; regenerating.",
                         self.data_dir, params)
        else:
            os.makedirs(self.data_dir)
        self.download_data()
        meta_path.write_text(json.dumps(params))

    def download_data(self) -> None:
        rng = np.random.default_rng(self.random_seed)
        n_generated = 2 * self.num_samples
        if self.n_channels == 1:
            phase = rng.normal(size=(n_generated, 1))
            frequency = rng.beta(a=2, b=2, size=(n_generated, 1))
            x = np.sin(np.arange(self.max_len) * frequency + phase)[:, :, None]
        else:
            phase = rng.normal(size=(n_generated, 1, self.n_channels))
            frequency = rng.beta(a=2, b=2, size=(n_generated, 1, self.n_channels))
            x = np.sin(np.arange(self.max_len)[None, :, None] * frequency + phase)
        x = x.astype(np.float32)
        np.save(self.data_dir / "train.npy", x[: self.num_samples])
        np.save(self.data_dir / "test.npy", x[self.num_samples:])

    def setup(self, stage: Optional[str] = None) -> None:
        """Load the splits (``stage`` is accepted for the JAX datamodule's
        interface; every stage loads both)."""
        self.X_train = np.load(self.data_dir / "train.npy")
        self.X_test = np.load(self.data_dir / "test.npy")

    def train_set(self) -> DiffusionDataset:
        return DiffusionDataset(
            X=self.X_train,
            fourier_transform=self.fourier_transform,
            standardize=self.standardize,
        )

    def train_dataloader(self) -> NumpyLoader:
        return NumpyLoader(self.train_set(), self.batch_size, shuffle=True,
                           seed=self.random_seed)

    def val_dataloader(self) -> NumpyLoader:
        val_set = DiffusionDataset(
            X=self.X_test,
            fourier_transform=self.fourier_transform,
            standardize=self.standardize,
            X_ref=self.X_train,
        )
        return NumpyLoader(val_set, self.batch_size, shuffle=False)

    def test_dataloader(self) -> NumpyLoader:
        test_set = DiffusionDataset(X=self.X_test, fourier_transform=self.fourier_transform)
        return NumpyLoader(test_set, self.batch_size, shuffle=False)

    @property
    def dataset_parameters(self) -> dict[str, Any]:
        return {
            "n_channels": int(self.X_train.shape[2]),
            "max_len": int(self.X_train.shape[1]),
            "num_training_steps": -(-len(self.X_train) // self.batch_size),
        }

    @property
    def feature_mean_and_std(self) -> tuple[np.ndarray, np.ndarray]:
        train_set = self.train_set()
        return train_set.feature_mean, train_set.feature_std
