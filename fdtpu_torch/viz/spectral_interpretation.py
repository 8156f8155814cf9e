"""Dataset-level spectral figures (port of
``fdtpu/viz/spectral_interpretation.py``): spectral density curves, the
temporal energy distribution, and time/frequency (joint) delocalization per
dataset.

The spectra and the delocalization run on the port's
:func:`~fdtpu_torch.ops.spectral_density` and
:func:`~fdtpu_torch.ops.localization_metrics`, on the card unless the caller
asks for the CPU (``device="cpu"``).  A dataset's tables are column tables:
a dict of column name → numpy array, one entry a row (a scalar column, such
as ``Dataset``, stands for every row), where the JAX package builds a
DataFrame.  matplotlib is imported inside the functions that draw.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from fdtpu_torch.ops import localization_metrics, spectral_density
from fdtpu_torch.utils.device import DeviceLike, resolve_device
from fdtpu_torch.utils.tables import series_mean, write_csv

Columns = dict[str, Any]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _density(x: np.ndarray, device: DeviceLike) -> np.ndarray:
    x = torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))
    return spectral_density(x).cpu().numpy()


def _localization(x: np.ndarray, device: DeviceLike) -> tuple[np.ndarray, np.ndarray]:
    x = torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))
    t_loc, f_loc = localization_metrics(x)
    return t_loc.cpu().numpy(), f_loc.cpu().numpy()


def plot_spectral_density(
    x: np.ndarray,
    label: str = "dataset",
    other: Optional[np.ndarray] = None,
    other_label: str = "generated",
    channel: int = 0,
    log_scale: bool = True,
    save_path: Optional[Path] = None,
    device: DeviceLike = None,
):
    """Mean per-frequency energy, optionally comparing two sample sets."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))

    def curve(data, lbl):
        ax.plot(_density(data, device)[:, :, channel].mean(axis=0), label=lbl)

    curve(x, label)
    if other is not None:
        curve(other, other_label)
    if log_scale:
        ax.set_yscale("log")
    ax.set_xlabel("frequency bin")
    ax.set_ylabel("spectral density")
    ax.legend()
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    return fig


def plot_temporal_energy(
    x: np.ndarray,
    label: str = "dataset",
    channel: int = 0,
    save_path: Optional[Path] = None,
):
    """Mean energy per time step."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot((x[:, :, channel] ** 2).mean(axis=0), label=label)
    ax.set_xlabel("time step")
    ax.set_ylabel("mean energy")
    ax.legend()
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    return fig


def plot_delocalization(
    datasets: dict[str, np.ndarray],
    save_path: Optional[Path] = None,
    device: DeviceLike = None,
):
    """Joint time/frequency delocalization scatter per dataset."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    for name, x in datasets.items():
        t_loc, f_loc = _localization(x, device)
        ax.scatter(t_loc, f_loc, s=8, alpha=0.5, label=name)
    ax.set_xlabel("time delocalization")
    ax.set_ylabel("frequency delocalization")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    return fig


# --------------------------------------------------------------------------
# Dataset batch processing: per-dataset column tables of normalized spectral
# density, temporal energy, and (joint) delocalization, over a registry of
# datamodules.
# --------------------------------------------------------------------------
_EPS = 1e-12


def process_dataset(dataset_name: str, datamodule, device: DeviceLike = None):
    """``prepare_data`` → ``setup`` → the (spectral, temporal, localization,
    localization_joint) column tables of one datamodule's train set."""
    datamodule.prepare_data()
    datamodule.setup()
    x = np.asarray(datamodule.X_train, dtype=np.float32)

    spec = _density(x, device)  # (N, F, C)
    share = spec.sum(axis=2, keepdims=True) / (_EPS + spec.sum(axis=(1, 2), keepdims=True))
    freq_norm = np.arange(spec.shape[1]) / max(1, spec.shape[1] - 1)
    spectral = {"Dataset": dataset_name, "Normalized Frequency": freq_norm,
                "Normalized Spectral Density": share.mean(axis=(0, 2)),
                "SE": share.std(axis=(0, 2)) / np.sqrt(len(spec))}

    energy = (x**2).sum(axis=2, keepdims=True) / (_EPS + (x**2).sum(axis=(1, 2), keepdims=True))
    temporal = {"Dataset": dataset_name,
                "Normalized Time": np.arange(x.shape[1]) / max(1, x.shape[1] - 1),
                "Normalized Energy": energy.mean(axis=(0, 2)), "SE": energy.std(axis=(0, 2))}

    t_loc, f_loc = _localization(x, device)
    localization = {"Dataset": dataset_name,
                    "Delocalization": np.concatenate([t_loc, f_loc]),
                    "Domain": np.array(["Time"] * len(t_loc) + ["Frequency"] * len(f_loc),
                                       dtype=object)}
    joint = {"Dataset": dataset_name, "Delocalization Time": t_loc,
             "Delocalization Frequency": f_loc}
    return spectral, temporal, localization, joint


def column_length(table: Columns) -> int:
    """The rows of a column table (a scalar column stands for every row)."""
    return max(len(v) for v in table.values() if isinstance(v, np.ndarray))


def column(table: Columns, name: str) -> np.ndarray:
    """One column of a column table, a scalar repeated over the rows."""
    v = table[name]
    return v if isinstance(v, np.ndarray) else np.array([v] * column_length(table), dtype=object)


def concat_columns(tables: list[Columns]) -> Columns:
    """The tables one after another (``pd.concat(..., ignore_index=True)``)."""
    return {name: np.concatenate([column(t, name) for t in tables]) for name in tables[0]}


def _rows(table: Columns) -> list[dict[str, Any]]:
    names = list(table)
    cols = [column(table, n).tolist() for n in names]
    return [dict(zip(names, values)) for values in zip(*cols)]


def default_dataset_registry(data_path: Path | str) -> dict:
    """The reference's six-dataset registry."""
    from fdtpu_torch.data import (
        ECGDatamodule,
        MIMICIIIDatamodule,
        NASADatamodule,
        NASDAQDatamodule,
        USDroughtsDatamodule,
    )

    return {
        "ECG": ECGDatamodule(data_dir=data_path),
        "MIMIC-III": MIMICIIIDatamodule(data_dir=data_path, n_feats=40),
        "NASDAQ-2019": NASDAQDatamodule(data_dir=data_path),
        "NASA-Charge": NASADatamodule(data_dir=data_path),
        "NASA-Discharge": NASADatamodule(data_dir=data_path, subdataset="discharge"),
        "US-Droughts": USDroughtsDatamodule(data_dir=data_path),
    }


def process_all_datasets(
    data_path: Path | str,
    output_dir: Optional[Path | str] = None,
    registry: Optional[dict] = None,
    device: DeviceLike = None,
):
    """The per-dataset analysis over a registry, skipping (with a warning)
    a dataset whose raw files are absent; the four tables concatenated, and
    written as CSV into ``output_dir``."""
    registry = registry if registry is not None else default_dataset_registry(data_path)
    frames: list[list] = [[], [], [], []]
    for name, dm in registry.items():
        try:
            results = process_dataset(name, dm, device=device)
        except Exception as exc:  # raw files absent, schema drift, …
            logging.warning("Skipping %s: %s", name, exc)
            continue
        for acc, frame in zip(frames, results):
            acc.append(frame)
    if not frames[0]:
        raise ValueError("No datasets could be processed")
    tables = tuple(concat_columns(acc) for acc in frames)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        names = ("spectral_density_datasets.csv", "temporal_energy_datasets.csv",
                 "localization_datasets.csv", "localization_joint_datasets.csv")
        for table, fname in zip(tables, names):
            write_csv(_rows(table), output_dir / fname)
    return tables


def plot_localization_bars(localization: Columns, save_path: Optional[Path] = None):
    """Per-dataset time/frequency delocalization bars, log scale."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    names, domains = column(localization, "Dataset"), column(localization, "Domain")
    values = localization["Delocalization"]
    datasets = list(dict.fromkeys(names.tolist()))
    width = 0.38
    xs = np.arange(len(datasets))
    for off, domain, color in ((-width / 2, "Time", "tab:blue"),
                               (width / 2, "Frequency", "tab:orange")):
        means = [series_mean(values[(names == d) & (domains == domain)]) for d in datasets]
        ax.bar(xs + off, means, width, label=domain, color=color)
    ax.set_yscale("log")
    ax.set_xticks(xs)
    ax.set_xticklabels(datasets, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("Delocalization metric")
    ax.legend(title="Domain", fontsize=7)
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_localization_joint(joint: Columns, save_path: Optional[Path] = None):
    """Joint time-against-frequency delocalization scatter with the
    identity line, log-log."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    names = column(joint, "Dataset")
    t_loc, f_loc = joint["Delocalization Time"], joint["Delocalization Frequency"]
    for name in dict.fromkeys(names.tolist()):
        keep = names == name
        ax.scatter(t_loc[keep], f_loc[keep], s=8, alpha=0.3, label=name)
    lims = (min(t_loc.min(), f_loc.min()), max(t_loc.max(), f_loc.max()))
    ax.plot(lims, lims, "k:", linewidth=1)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("Delocalization Time")
    ax.set_ylabel("Delocalization Frequency")
    ax.legend(loc="lower right", fontsize=7, title="Dataset")
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig


def spectral_interpretation_main(
    data_path: Path | str,
    output_dir: Path | str,
    registry: Optional[dict] = None,
    device: DeviceLike = None,
) -> None:
    """The dataset-level pipeline: batch analysis → CSVs → the four figure
    families."""
    output_dir = Path(output_dir)
    spectral, temporal, loc, loc_joint = process_all_datasets(
        data_path, output_dir, registry=registry, device=device)
    figures = output_dir / "figures"
    figures.mkdir(parents=True, exist_ok=True)
    plt = _plt()

    for table, x, y, ylabel, stem, log in (
        (spectral, "Normalized Frequency", "Normalized Spectral Density",
         "Normalized spectral density", "spectral_density_datasets", True),
        (temporal, "Normalized Time", "Normalized Energy", "Normalized energy",
         "temporal_energy_datasets", False),
    ):
        fig, ax = plt.subplots(figsize=(6, 4))
        names = column(table, "Dataset")
        for name in dict.fromkeys(names.tolist()):
            keep = names == name
            ax.plot(table[x][keep], table[y][keep], label=name)
        if log:
            ax.set_yscale("log")
        ax.set_xlabel(x[0] + x[1:].lower())
        ax.set_ylabel(ylabel)
        ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(figures / f"{stem}.pdf", bbox_inches="tight")
        plt.close(fig)

    plot_localization_bars(loc, save_path=figures / "localization_datasets.pdf")
    plot_localization_joint(loc_joint, save_path=figures / "localization_joint_datasets.png")
