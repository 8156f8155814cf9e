"""Sample visualization (port of ``fdtpu/viz/visualize.py``).

Line plots and heatmaps of generated samples next to training data, loaded
from a run directory's ``samples.npy`` (which the sample CLI writes in the
data domain); the training data is rebuilt from the run's
``train_config.yaml``.  matplotlib is imported inside the functions that
draw.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_sample_lines(
    samples: np.ndarray,
    reference: Optional[np.ndarray] = None,
    n_examples: int = 8,
    channel: int = 0,
    title: str = "Generated samples",
    save_path: Optional[Path] = None,
):
    """Overlay line plots of generated (and optionally real) series."""
    plt = _plt()
    fig, axes = plt.subplots(
        1, 2 if reference is not None else 1, figsize=(11, 3.5), squeeze=False
    )
    ax = axes[0, 0]
    for i in range(min(n_examples, len(samples))):
        ax.plot(samples[i, :, channel], alpha=0.7, lw=1)
    ax.set_title(title)
    ax.set_xlabel("time step")
    if reference is not None:
        ax2 = axes[0, 1]
        for i in range(min(n_examples, len(reference))):
            ax2.plot(reference[i, :, channel], alpha=0.7, lw=1)
        ax2.set_title("Training data")
        ax2.set_xlabel("time step")
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    return fig


def plot_sample_heatmap(
    samples: np.ndarray,
    n_examples: int = 64,
    channel: int = 0,
    title: str = "Generated samples",
    save_path: Optional[Path] = None,
):
    """Heatmap of many samples stacked on the vertical axis."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 5))
    data = samples[:n_examples, :, channel]
    im = ax.imshow(data, aspect="auto", cmap="viridis", interpolation="nearest")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    ax.set_xlabel("time step")
    ax.set_ylabel("sample")
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    return fig


# ---------------------------------------------------------------------------
# Multi-run comparison grids: rows = sample index, columns = domains
# ("train" | "freq" | "time" | ...) sorted train-first, line and heatmap
# variants, loaded from run dirs keyed by a ``model_ids`` mapping.
# ---------------------------------------------------------------------------

_DOMAIN_ORDER = {"train": 0, "freq": 1, "time": 2}

LEGEND_MAPPING = {
    "train": "Training samples",
    "freq": "Generated samples (Frequency domain model)",
    "time": "Generated samples (Time domain model)",
}


def _ordered(samples_dict: dict[str, np.ndarray]) -> list[tuple[str, np.ndarray]]:
    return sorted(samples_dict.items(), key=lambda kv: _DOMAIN_ORDER.get(kv[0], 3))


def get_train_samples(model_id: str, runs_dir: Path | str) -> np.ndarray:
    """Raw (data-domain) training samples of a run, rebuilt from its
    persisted ``train_config.yaml``."""
    from fdtpu_torch.utils.builders import build_datamodule, resolve_model_dir
    from fdtpu_torch.utils.config import load_config

    model_dir = resolve_model_dir(runs_dir, model_id)
    train_cfg = load_config(model_dir / "train_config.yaml")
    dm = build_datamodule(train_cfg)
    dm.prepare_data()
    dm.setup("fit")
    return np.asarray(dm.X_train)


def load_samples(
    model_ids: dict[str, str],
    runs_dir: Path | str,
    include_train: bool = True,
    random_seed: int = 0,
) -> dict[str, np.ndarray]:
    """Load each run's ``samples.npy`` (shuffled with a seeded PRNG) keyed
    by domain name, plus the first run's training data under ``"train"``."""
    runs_dir = Path(runs_dir)
    rng = np.random.default_rng(random_seed)
    samples_dict: dict[str, np.ndarray] = {}
    for domain, model_id in model_ids.items():
        path = runs_dir / model_id / "samples.npy"
        if not path.exists():
            import warnings

            warnings.warn(f"samples not found for {domain!r} at {path}")
            continue
        samples = np.load(path)
        samples_dict[domain] = samples[rng.permutation(len(samples))]
    if include_train and model_ids:
        train = get_train_samples(next(iter(model_ids.values())), runs_dir)
        samples_dict["train"] = train[rng.permutation(len(train))]
    return samples_dict


def plot_samples_grid(
    samples_dict: dict[str, np.ndarray],
    n_samples: int = 5,
    save_path: Optional[Path] = None,
):
    """Line-plot grid: one row per sample, one column per domain, every
    channel as a line."""
    plt = _plt()
    cols = max(len(samples_dict), 1)
    fig, ax = plt.subplots(
        n_samples, cols, figsize=(4.5 * cols, 2.6 * n_samples), squeeze=False
    )
    for k in range(n_samples):
        for i, (domain, samples) in enumerate(_ordered(samples_dict)):
            sample = samples[min(k, len(samples) - 1)]
            for j in range(sample.shape[-1]):
                ax[k, i].plot(sample[:, j], lw=0.9, label=f"Feature {j}")
            if k == 0:
                ax[k, i].set_title(LEGEND_MAPPING.get(domain, domain), fontsize=10)
            if sample.shape[-1] <= 5:
                ax[k, i].legend(fontsize=6)
    fig.tight_layout()
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    return fig, ax


def heatmap_samples_grid(
    samples_dict: dict[str, np.ndarray],
    n_samples: int = 5,
    save_path: Optional[Path] = None,
):
    """Heatmap grid: per-sample (channels × time) heatmaps, symmetric color
    scale per sample."""
    plt = _plt()
    cols = max(len(samples_dict), 1)
    fig, ax = plt.subplots(
        n_samples, cols, figsize=(4.5 * cols, 2.6 * n_samples), squeeze=False
    )
    for k in range(n_samples):
        for i, (domain, samples) in enumerate(_ordered(samples_dict)):
            sample = samples[min(k, len(samples) - 1)]
            vmax = float(np.abs(sample).max()) or 1.0
            im = ax[k, i].imshow(
                sample.T, aspect="auto", cmap="RdBu_r", vmin=-vmax, vmax=vmax,
                interpolation="nearest",
            )
            fig.colorbar(im, ax=ax[k, i], fraction=0.046)
            if k == 0:
                ax[k, i].set_title(LEGEND_MAPPING.get(domain, domain), fontsize=10)
    fig.tight_layout()
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    return fig, ax


def visualize_model_comparison(
    model_ids: dict[str, str],
    runs_dir: Path | str,
    output_dir: Path | str,
    dataset_name: Optional[str] = None,
    n_samples: int = 5,
    include_train: bool = True,
    plot_types: tuple[str, ...] = ("line", "heatmap"),
    random_seed: int = 0,
) -> list[Path]:
    """Freq-vs-time-vs-train comparison figures across runs: loads every
    run's samples, writes ``<dataset>_samples_<plot_type>.png`` per
    variant."""
    samples_dict = load_samples(
        model_ids, runs_dir, include_train=include_train, random_seed=random_seed
    )
    if not samples_dict:
        raise ValueError("No samples loaded")
    if dataset_name is None:
        dataset_name = next(iter(model_ids.values()))
    out = Path(output_dir) / "figures"
    paths = []
    for plot_type in plot_types:
        path = out / f"{dataset_name}_samples_{plot_type}.png"
        if plot_type == "line":
            plot_samples_grid(samples_dict, n_samples, save_path=path)
        elif plot_type == "heatmap":
            heatmap_samples_grid(samples_dict, n_samples, save_path=path)
        else:
            raise ValueError(f"Unknown plot_type: {plot_type}")
        paths.append(path)
    return paths


def visualize_samples(
    run_dir: Path | str,
    reference: Optional[np.ndarray] = None,
    out_dir: Optional[Path] = None,
) -> list[Path]:
    """Produce the standard figure set for a run's ``samples.npy``."""
    run_dir = Path(run_dir)
    samples = np.load(run_dir / "samples.npy")
    out_dir = Path(out_dir) if out_dir is not None else run_dir / "figures"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    p = out_dir / "samples_lines.png"
    plot_sample_lines(samples, reference=reference, save_path=p)
    paths.append(p)
    p = out_dir / "samples_heatmap.png"
    plot_sample_heatmap(samples, save_path=p)
    paths.append(p)
    return paths
