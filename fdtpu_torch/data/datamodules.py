"""Datamodules of the six datasets (port of ``fdtpu/data/datamodules.py``).

A datamodule has the JAX package's lifecycle, ``prepare_data`` (download, or
generate) → ``setup`` (load, preprocessing the raw files on first use) → the
loaders: a shuffled train loader seeded with ``random_seed``, a val loader
over the test split standardized with the train statistics, and an
unstandardized test loader.  The filters, feature drops and shape asserts
are the JAX package's; the raw files are read without pandas
(:mod:`fdtpu_torch.data.preprocessing`).  Downloads go through the Kaggle
API where it is installed; otherwise the error says where to put the files.

``SyntheticDatamodule``'s arrays are bit-identical to the JAX package's; it
stores float32 ``.npy`` files for every channel count, where the JAX package
writes univariate data as CSV through pandas (the values round-trip exactly
either way).  ECG's ``subsample_localization`` and ``smooth_frequency`` run
on the host, as the dataset's DFT does.
"""

from __future__ import annotations

import json
import logging
import os
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from fdtpu_torch.data.dataset import DiffusionDataset, NumpyLoader
from fdtpu_torch.data.preprocessing import (
    droughts_preprocess,
    load_tensor,
    mimic_preprocess,
    nasa_preprocess,
    nasdaq_preprocess,
)
from fdtpu_torch.ops import localization_metrics, smooth_frequency

# The ECG CSVs' columns: 187 samples, then the class label.
ECG_LENGTH = 187
# subsample_localization keeps this many of the most time-localized series.
ECG_LOCALIZED = 1000


class Datamodule(ABC):
    """Base datamodule (``fdtpu/data/datamodules.py:34-164``)."""

    def __init__(
        self,
        data_dir: Path | str = "data",
        random_seed: int = 42,
        batch_size: int = 32,
        fourier_transform: bool = False,
        standardize: bool = False,
    ) -> None:
        self.data_dir = Path(data_dir) / self.dataset_name
        self.random_seed = random_seed
        self.batch_size = batch_size
        self.fourier_transform = fourier_transform
        self.standardize = standardize
        self.X_train: np.ndarray = np.zeros((0, 0, 0), np.float32)
        self.y_train: Optional[np.ndarray] = None
        self.X_test: np.ndarray = np.zeros((0, 0, 0), np.float32)
        self.y_test: Optional[np.ndarray] = None
        # Split → (the arrays it was built from, its dataset): the dataset's
        # DFT and statistics are computed once per setup, not per epoch.
        self._ds_cache: dict[str, tuple[tuple, DiffusionDataset]] = {}

    def _cached_dataset(self, split: str, builder: Callable[[], DiffusionDataset],
                        *arrays: np.ndarray) -> DiffusionDataset:
        # Compared by identity with the stored arrays, which the cache keeps
        # alive, so a freed array's id cannot serve a stale dataset.
        hit = self._ds_cache.get(split)
        if hit is None or len(hit[0]) != len(arrays) or any(
                a is not b for a, b in zip(hit[0], arrays)):
            self._ds_cache[split] = (tuple(arrays), builder())
        return self._ds_cache[split][1]

    def prepare_data(self) -> None:
        if not self.data_dir.exists():
            logging.info("Downloading %s dataset into %s.", self.dataset_name, self.data_dir)
            os.makedirs(self.data_dir)
            self.download_data()

    @abstractmethod
    def download_data(self) -> None: ...

    @abstractmethod
    def setup(self, stage: str = "fit") -> None: ...

    @property
    @abstractmethod
    def dataset_name(self) -> str: ...

    def _kaggle_download(self, slug: str) -> None:
        try:
            import kaggle
        except ImportError as exc:
            raise RuntimeError(
                f"Dataset {self.dataset_name} is missing from {self.data_dir} and the "
                f"kaggle package is unavailable (no network egress here). Download "
                f"https://www.kaggle.com/datasets/{slug} manually and unzip it into "
                f"{self.data_dir}."
            ) from exc
        kaggle.api.authenticate()
        kaggle.api.dataset_download_files(slug, path=self.data_dir, unzip=True)

    def train_set(self) -> DiffusionDataset:
        return self._cached_dataset(
            "train",
            lambda: DiffusionDataset(X=self.X_train, y=self.y_train,
                                     fourier_transform=self.fourier_transform,
                                     standardize=self.standardize),
            self.X_train)

    def train_dataloader(self) -> NumpyLoader:
        return NumpyLoader(self.train_set(), self.batch_size, shuffle=True,
                           seed=self.random_seed)

    def val_dataloader(self) -> NumpyLoader:
        val_set = self._cached_dataset(
            "val",
            lambda: DiffusionDataset(X=self.X_test, y=self.y_test,
                                     fourier_transform=self.fourier_transform,
                                     standardize=self.standardize, X_ref=self.X_train),
            self.X_test, self.X_train)
        return NumpyLoader(val_set, self.batch_size, shuffle=False)

    def test_dataloader(self) -> NumpyLoader:
        test_set = self._cached_dataset(
            "test",
            lambda: DiffusionDataset(X=self.X_test, y=self.y_test,
                                     fourier_transform=self.fourier_transform),
            self.X_test)
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
        train_set = DiffusionDataset(X=self.X_train, y=self.y_train,
                                     fourier_transform=self.fourier_transform,
                                     standardize=self.standardize)
        return train_set.feature_mean, train_set.feature_std

    def _preprocessed(self) -> bool:
        return any((self.data_dir / f"X_train{ext}").exists() for ext in (".npy", ".pt"))


def read_ecg_csv(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """One MIT-BIH CSV as ``(X (N, 187, 1) float32, y (N,) int64)``.  The
    files have no header, but the JAX package reads them with pandas'
    default one, so their first row is dropped here as there.  The table is
    column-major, as a pandas frame's ``.values`` is, so that statistics over
    the series (``X.mean(axis=0)``) sum in the JAX package's order."""
    table = np.asfortranarray(
        np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64, ndmin=2))
    return (table[:, :ECG_LENGTH].astype(np.float32)[:, :, None],
            table[:, ECG_LENGTH].astype(np.int64))


class ECGDatamodule(Datamodule):
    """MIT-BIH heartbeats: 187 steps × 1 channel (``:167-223``)."""

    def __init__(
        self,
        data_dir: Path | str = "data",
        random_seed: int = 42,
        batch_size: int = 32,
        fourier_transform: bool = False,
        standardize: bool = False,
        subsample_localization: bool = False,
        smooth_frequency: bool = False,
        smoother_width: float = 0.0,
    ) -> None:
        super().__init__(data_dir=data_dir, random_seed=random_seed, batch_size=batch_size,
                         fourier_transform=fourier_transform, standardize=standardize)
        self.subsample_localization = subsample_localization
        self.smooth_frequency = smooth_frequency
        self.smoother_width = smoother_width

    def setup(self, stage: str = "fit") -> None:
        self.X_train, self.y_train = read_ecg_csv(self.data_dir / "mitbih_train.csv")
        self.X_test, self.y_test = read_ecg_csv(self.data_dir / "mitbih_test.csv")

        if self.subsample_localization:
            # Keep the most time-localized series.
            x_loc, x_spec_loc = localization_metrics(torch.from_numpy(self.X_train))
            ranking = np.argsort(x_loc.numpy() / x_spec_loc.numpy())
            self.X_train = self.X_train[ranking[:ECG_LOCALIZED]]
            self.y_train = self.y_train[ranking[:ECG_LOCALIZED]]
            logging.info("Subsampled the training set by localization score.")

        if self.smooth_frequency and self.smoother_width > 0.0:
            self.X_train = smooth_frequency(torch.from_numpy(self.X_train),
                                            self.smoother_width).numpy()
            self.X_test = smooth_frequency(torch.from_numpy(self.X_test),
                                           self.smoother_width).numpy()
            logging.info("Smoothed the frequency domain of the data.")

    def download_data(self) -> None:
        self._kaggle_download("shayanfazeli/heartbeat")

    @property
    def dataset_name(self) -> str:
        return "ecg"


class SyntheticDatamodule(Datamodule):
    """``sin(t·f + φ)``, ``f ~ Beta(2, 2)``, ``φ ~ N(0, 1)``, each channel
    with its own draws (``:226-334``); generated locally from the seed."""

    def __init__(
        self,
        data_dir: Path | str = "data",
        random_seed: int = 42,
        batch_size: int = 32,
        fourier_transform: bool = False,
        standardize: bool = False,
        max_len: int = 100,
        num_samples: int = 1000,
        n_channels: int = 1,
    ) -> None:
        self.n_channels = n_channels
        super().__init__(data_dir=data_dir, random_seed=random_seed, batch_size=batch_size,
                         fourier_transform=fourier_transform, standardize=standardize)
        self.max_len = max_len
        self.num_samples = num_samples

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

    def setup(self, stage: str = "fit") -> None:
        self.X_train = np.load(self.data_dir / "train.npy")
        self.X_test = np.load(self.data_dir / "test.npy")
        self.y_train = self.y_test = None


class MIMICIIIDatamodule(Datamodule):
    """Restricted MIMIC-III; keeps the top-variance features (``:336-381``).
    The raw ``all_hourly_data.h5`` needs h5py to preprocess; where there is
    none, put the ``X_train.npy``/``X_test.npy`` that ``mimic_preprocess``
    wrote on another machine into the dataset directory."""

    def __init__(
        self,
        data_dir: Path | str = "data",
        random_seed: int = 42,
        batch_size: int = 32,
        fourier_transform: bool = False,
        standardize: bool = False,
        n_feats: int = 40,
    ) -> None:
        super().__init__(data_dir=data_dir, random_seed=random_seed, batch_size=batch_size,
                         fourier_transform=fourier_transform, standardize=standardize)
        self.n_feats = n_feats

    def setup(self, stage: str = "fit") -> None:
        if not self._preprocessed():
            mimic_preprocess(data_dir=self.data_dir, random_seed=self.random_seed)
        self.X_train = load_tensor(self.data_dir / "X_train")
        self.X_test = load_tensor(self.data_dir / "X_test")

        # Keep the features with the highest population variance.
        top = np.argsort(self.X_train.std(axis=0).mean(axis=0))[::-1][: self.n_feats]
        self.X_train = self.X_train[:, :, top]
        self.X_test = self.X_test[:, :, top]

    def download_data(self) -> None:
        dataset_path = self.data_dir / "all_hourly_data.h5"
        assert dataset_path.exists(), (
            f"Dataset {dataset_path} does not exist. MIMIC-III is restricted; "
            "download the MIMIC-Extract preprocessed version yourself "
            "(https://github.com/MLforHealth/MIMIC_Extract)."
        )

    @property
    def dataset_name(self) -> str:
        return "mimiciii"


class NASDAQDatamodule(Datamodule):
    """2019 NASDAQ stocks ``(N, 252, 6)`` → volume dropped → ``(N, 252, 5)``
    (``:384-405``).  The pivot sorts the features by name, so the last one
    is ``Volume``."""

    def setup(self, stage: str = "fit") -> None:
        if not self._preprocessed():
            nasdaq_preprocess(data_dir=self.data_dir, random_seed=self.random_seed)
        self.X_train = load_tensor(self.data_dir / "X_train")
        self.X_test = load_tensor(self.data_dir / "X_test")
        assert self.X_train.shape[1:] == self.X_test.shape[1:] == (252, 6)
        self.X_train = self.X_train[:, :, :-1]
        self.X_test = self.X_test[:, :, :-1]

    def download_data(self) -> None:
        self._kaggle_download("jacksoncrow/stock-market-dataset")

    @property
    def dataset_name(self) -> str:
        return "nasdaq"


class NASADatamodule(Datamodule):
    """NASA battery charge/discharge cycles (``:408-455``)."""

    def __init__(
        self,
        data_dir: Path | str = "data",
        random_seed: int = 42,
        batch_size: int = 32,
        fourier_transform: bool = False,
        standardize: bool = False,
        subdataset: str = "charge",
        remove_outlier_feature: bool = True,
    ) -> None:
        self.subdataset = subdataset
        self.remove_outlier_feature = remove_outlier_feature
        super().__init__(data_dir=data_dir, random_seed=random_seed, batch_size=batch_size,
                         fourier_transform=fourier_transform, standardize=standardize)

    def setup(self, stage: str = "fit") -> None:
        sub = self.data_dir / self.subdataset
        if not any((sub / f"X_train{ext}").exists() for ext in (".npy", ".pt")):
            nasa_preprocess(data_dir=self.data_dir, subdataset=self.subdataset,
                            random_seed=self.random_seed)
        self.X_train = load_tensor(sub / "X_train")
        self.X_test = load_tensor(sub / "X_test")

        if self.remove_outlier_feature and self.subdataset == "charge":
            # Drop the outlier-range feature and stride the time axis:
            # (N, 501, 5) → (N, 251, 4).
            self.X_train = self.X_train[:, ::2][:, :, [0, 1, 3, 4]]
            self.X_test = self.X_test[:, ::2][:, :, [0, 1, 3, 4]]
            assert self.X_train.shape[1] == self.X_test.shape[1] == 251
            assert self.X_train.shape[2] == self.X_test.shape[2] == 4

    def download_data(self) -> None:
        self._kaggle_download("patrickfleith/nasa-battery-dataset")

    @property
    def dataset_name(self) -> str:
        return "nasa"


class USDroughtsDatamodule(Datamodule):
    """One year of daily county meteorology; drops the T2M-correlated
    features, counted in the pivot's name order over the columns that have
    no missing value in the year (``:458-481``)."""

    def setup(self, stage: str = "fit") -> None:
        if not self._preprocessed():
            droughts_preprocess(data_dir=self.data_dir, random_seed=self.random_seed)
        self.X_train = load_tensor(self.data_dir / "X_train")
        self.X_test = load_tensor(self.data_dir / "X_test")

        feats = [i for i in range(self.X_train.shape[2]) if i not in {4, 5, 6, 7, 9}]
        self.X_train = self.X_train[:, :, feats]
        self.X_test = self.X_test[:, :, feats]
        assert self.X_train.shape[1] % 365 == self.X_test.shape[1] % 365 == 0

    def download_data(self) -> None:
        self._kaggle_download("cdminix/us-drought-meteorological-data")

    @property
    def dataset_name(self) -> str:
        return "droughts"


DATAMODULE_REGISTRY: dict[str, type[Datamodule]] = {
    "ecg": ECGDatamodule,
    "synthetic": SyntheticDatamodule,
    "mimiciii": MIMICIIIDatamodule,
    "nasdaq": NASDAQDatamodule,
    "nasa": NASADatamodule,
    "usdroughts": USDroughtsDatamodule,
}
