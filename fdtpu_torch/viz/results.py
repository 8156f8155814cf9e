"""Results aggregation across runs (port of ``fdtpu/viz/results.py``).

Collects the ``results.yaml`` of many run directories into row dicts (one
dict a row, where the JAX package builds a DataFrame), plots quality against
the self/dummy baselines, and writes the summary tables as CSV and LaTeX.
The tables are pandas' byte for byte: the frame operations are
:mod:`fdtpu_torch.utils.tables`'.  ``results.yaml`` and
``train_config.yaml`` are read with :mod:`fdtpu_torch.utils.yaml_subset`.
matplotlib is imported inside the functions that draw.
"""

from __future__ import annotations

from itertools import product
from pathlib import Path
from typing import Any, Optional

import numpy as np

from fdtpu_torch.utils import yaml_subset
from fdtpu_torch.utils.tables import (
    Grid,
    column_names,
    concat_blocks,
    float_text,
    grid_latex,
    groupby_mean_std,
    kahan_mean,
    pivot_table,
    sem,
    series_mean,
    write_csv,
    write_grid_csv,
)

Rows = list[dict[str, Any]]

PRIMARY_METRICS = [
    "time_sliced_wasserstein_mean",
    "freq_sliced_wasserstein_mean",
    "time_marginal_wasserstein_mean",
    "freq_marginal_wasserstein_mean",
]

#: datamodule name (config ``datamodule.name``) → the paper's display name
DATASET_DISPLAY = {
    "ecg": "ECG",
    "mimiciii": "MIMIC-III",
    "nasdaq": "NASDAQ-2019",
    "usdroughts": "US-Droughts",
    "synthetic": "Synthetic",
}


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def infer_dataset(config: dict[str, Any]) -> str:
    """The paper's display name of a run's dataset; NASA splits on the
    charge/discharge subdataset."""
    dm = config.get("datamodule", {}) or {}
    name = str(dm.get("name", "")).lower()
    if name == "nasa":
        sub = str(dm.get("subdataset", "charge")).lower()
        return "NASA-Charge" if sub == "charge" else "NASA-Discharge"
    return DATASET_DISPLAY.get(name, "Unknown")


def infer_diffusion_domain(config: dict[str, Any]) -> str:
    """``"Time"`` or ``"Frequency"``."""
    return "Frequency" if config.get("fourier_transform") else "Time"


def _metric_name(method: str) -> str:
    return "Sliced Wasserstein" if method == "sliced" else "Marginal Wasserstein"


def _domain_name(domain: str) -> str:
    return "Frequency" if domain == "freq" else "Time"


def calculate_metrics(results: dict[str, Any]) -> Rows:
    """A row per distance of each ``*_wasserstein_all`` list."""
    data = []
    for domain, method in product(("time", "freq"), ("sliced", "marginal")):
        key = f"{domain}_{method}_wasserstein_all"
        if key in results:
            data.extend({"Value": distance, "Metric Domain": _domain_name(domain),
                         "Metric": _metric_name(method)} for distance in results[key])
    return data


def calculate_baselines(results: dict[str, Any]) -> Rows:
    """The self (half train) and dummy (mean) baseline rows."""
    data = []
    for baseline, domain, method in product(
        ("dummy", "self"), ("time", "freq"), ("sliced", "marginal")
    ):
        key = f"{domain}_{method}_wasserstein_mean_{baseline}"
        if key in results:
            data.append({"Value": results[key],
                         "Baseline": "Mean" if baseline == "dummy" else "Half Train",
                         "Metric Domain": _domain_name(domain),
                         "Metric": _metric_name(method)})
    return data


def process_results(runs_dir: Path | str) -> Rows:
    """One row per run: its config summary and its scalar metrics."""
    rows = []
    for run in sorted(Path(runs_dir).glob("*")):
        results_path = run / "results.yaml"
        config_path = run / "train_config.yaml"
        if not results_path.exists():
            continue
        results = yaml_subset.load(results_path)
        row: dict = {"run_id": run.name}
        if config_path.exists():
            cfg = yaml_subset.load(config_path)
            row.update(
                dataset=cfg.get("datamodule", {}).get("name"),
                backbone=cfg.get("score_model", {}).get("backbone"),
                fourier_transform=cfg.get("fourier_transform"),
                scheduler=cfg.get("score_model", {}).get("noise_scheduler", {}).get("class"),
            )
        row.update({k: v for k, v in results.items() if not isinstance(v, list)})
        rows.append(row)
    return rows


def _column_values(rows: Rows, name: str) -> np.ndarray:
    return np.array([np.nan if row.get(name) is None else row[name] for row in rows],
                    np.float64)


def plot_sample_quality(rows: Rows, metric: str = "time_sliced_wasserstein_mean",
                        save_path: Optional[Path] = None):
    """Bar plot of a quality metric per run, with the self/dummy baseline
    means as lines."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(max(6, 0.9 * len(rows)), 4))
    names = column_names(rows)
    labels = [f"{row.get('dataset') if 'dataset' in names else row['run_id']}:{row['run_id']}"
              for row in rows]
    ax.bar(labels, _column_values(rows, metric))
    for suffix, style in (("_self", "--"), ("_dummy", ":")):
        col = metric + suffix
        if col in names:
            ax.axhline(series_mean(_column_values(rows, col)), ls=style, color="k", label=col)
    ax.set_ylabel(metric)
    ax.tick_params(axis="x", rotation=45)
    ax.legend()
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    return fig


def results_to_latex(rows: Rows, metrics: Optional[list[str]] = None) -> str:
    """The LaTeX summary table: mean ± std per (dataset, backbone) group,
    or the metrics rounded to 3 decimals a run where the rows have neither."""
    names = column_names(rows)
    metrics = metrics or [m for m in PRIMARY_METRICS if m in names]
    group_cols = [c for c in ("dataset", "backbone") if c in names]
    if group_cols:
        keys, means, stds = groupby_mean_std(rows, group_cols, metrics)
        cells = np.array([[f"{m:.3f} $\\pm$ {0.0 if np.isnan(s) else s:.3f}"
                           for m, s in zip(mean_row, std_row)]
                          for mean_row, std_row in zip(means, stds)], dtype=object)
        table = Grid(group_cols, keys, [None], [(m,) for m in metrics],
                     cells.reshape(len(keys), len(metrics)))
    else:
        values = np.stack([_column_values(rows, m) for m in metrics], axis=1)
        table = Grid([None], [(i,) for i in range(len(rows))], [None],
                     [(m,) for m in metrics], np.round(values, 3))
    return grid_latex(table)


def process_all_datasets(runs_dir: Path | str, out_dir: Path | str) -> Rows:
    """Aggregate → ``results_summary.csv`` → quality plots →
    ``results_table.tex``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = process_results(runs_dir)
    if not rows:
        return rows
    write_csv(rows, out_dir / "results_summary.csv")
    names = column_names(rows)
    for metric in PRIMARY_METRICS:
        if metric in names:
            plot_sample_quality(rows, metric, save_path=out_dir / f"quality_{metric}.png")
    (out_dir / "results_table.tex").write_text(results_to_latex(rows))
    return rows


# --------------------------------------------------------------------------
# The per-distance pipeline: rows over the *_wasserstein_all lists,
# per-(metric, dataset) quality boxes against the baselines, per-run spectral
# profiles, summary pivots.
# --------------------------------------------------------------------------
def _load_run(run_path: Path) -> Optional[tuple[dict, dict]]:
    config_path = run_path / "train_config.yaml"
    results_path = run_path / "results.yaml"
    if not (config_path.exists() and results_path.exists()):
        return None
    return yaml_subset.load(config_path), yaml_subset.load(results_path)


def process_run_metrics(
    run_ids: list[str],
    runs_dir: Path | str,
    output_dir: Optional[Path | str] = None,
) -> tuple[Rows, Rows]:
    """Per-distance rows across runs → ``(metrics, baselines)``, each row
    with its Dataset and Diffusion Domain; ``metrics.csv`` and
    ``baselines.csv`` in ``output_dir``."""
    runs_dir = Path(runs_dir)
    metrics, baselines, found = [], [], False
    for run_id in run_ids:
        loaded = _load_run(runs_dir / run_id)
        if loaded is None:
            continue
        found = True
        config, results = loaded
        tags = {"Dataset": infer_dataset(config),
                "Diffusion Domain": infer_diffusion_domain(config)}
        metrics += [{**row, **tags} for row in calculate_metrics(results)]
        baselines += [{**row, **tags} for row in calculate_baselines(results)]
    if not found:
        raise ValueError(f"No valid runs found under {runs_dir}")
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        write_csv(metrics, output_dir / "metrics.csv")
        write_csv(baselines, output_dir / "baselines.csv")
    return metrics, baselines


def _unique(rows: Rows, name: str) -> list:
    """``Series.unique()``: the values in first-seen order."""
    return list(dict.fromkeys(row[name] for row in rows))


def _where(rows: Rows, equal: dict[str, Any]) -> Rows:
    """The rows whose columns hold the given values."""
    return [r for r in rows if all(r.get(k) == v for k, v in equal.items())]



def plot_quality_boxes(metrics: Rows, baselines: Rows,
                       output_dir: Optional[Path | str] = None) -> list:
    """A box plot per (metric, dataset) of the per-distance values, split by
    metric and diffusion domain, with the baselines' means as markers."""
    plt = _plt()
    figs = []
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
    domains = ["Time", "Frequency"]
    for metric in _unique(metrics, "Metric"):
        for dataset in _unique(metrics, "Dataset"):
            sub = _where(metrics, {"Metric": metric, "Dataset": dataset})
            if not sub:
                continue
            fig, ax = plt.subplots(figsize=(5, 4))
            positions, labels = [], []
            for i, mdomain in enumerate(domains):
                for j, ddomain in enumerate(domains):
                    vals = _column_values(_where(sub, {"Metric Domain": mdomain,
                                                       "Diffusion Domain": ddomain}), "Value")
                    if len(vals) == 0:
                        continue
                    pos = i * 2.4 + j
                    ax.boxplot([vals], positions=[pos], widths=0.7, showfliers=False)
                    positions.append(pos)
                    labels.append(f"{mdomain[:4]}\n{ddomain[:4]} diff.")
            base = _where(baselines, {"Metric": metric, "Dataset": dataset})
            for bl, marker, color in (("Mean", "v", "tab:red"),
                                      ("Half Train", "^", "tab:green")):
                for i, mdomain in enumerate(domains):
                    vals = _column_values(_where(base, {"Baseline": bl, "Metric Domain": mdomain}),
                                          "Value")
                    if len(vals):
                        ax.plot([i * 2.4 + 0.5], [vals.mean()], marker=marker,
                                color=color, label=bl if i == 0 else None)
            ax.set_xticks(positions)
            ax.set_xticklabels(labels, fontsize=7)
            ax.set_ylabel(f"{metric} (lower is better)")
            ax.set_title(dataset)
            if ax.get_legend_handles_labels()[0]:
                ax.legend(fontsize=7, title="Baseline")
            fig.tight_layout()
            if output_dir is not None:
                name = (f"{metric.lower().replace(' ', '_')}_"
                        f"{dataset.lower().replace('-', '_')}.pdf")
                fig.savefig(output_dir / name, bbox_inches="tight")
                plt.close(fig)
            figs.append(fig)
    return figs


def calculate_spectral_profile(marginal_spectral: list[float], n_channels: int) -> np.ndarray:
    """The ``(freq · channels,)`` spectral marginal-Wasserstein list → its
    mean over channels at each frequency."""
    arr = np.asarray(marginal_spectral, dtype=np.float64)
    return arr.reshape(-1, n_channels).mean(axis=1)


def process_spectral_analysis(
    run_ids: list[str],
    runs_dir: Path | str,
    output_dir: Optional[Path | str] = None,
) -> Rows:
    """Each run's spectral-density Wasserstein profile as rows
    (``spectral_density.csv`` in ``output_dir``); the channel count comes
    from ``samples.npy``."""
    runs_dir = Path(runs_dir)
    rows = []
    for run_id in run_ids:
        run_path = runs_dir / run_id
        loaded = _load_run(run_path)
        samples_path = run_path / "samples.npy"
        if loaded is None or not samples_path.exists():
            continue
        config, results = loaded
        if "spectral_marginal_wasserstein_all" not in results:
            continue
        n_channels = int(np.load(samples_path, mmap_mode="r").shape[-1])
        profile = calculate_spectral_profile(results["spectral_marginal_wasserstein_all"],
                                             n_channels)
        freqs = np.arange(len(profile)) / len(profile)
        rows.extend({"Dataset": infer_dataset(config),
                     "Diffusion Domain": infer_diffusion_domain(config),
                     "Frequency": float(freqs[k]),
                     "Spectral Density": float(profile[k])} for k in range(len(profile)))
    if not rows:
        raise ValueError("No spectral data found")
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        write_csv(rows, output_dir / "spectral_density.csv")
    return rows


def plot_run_spectral_density(spectral: Rows, output_dir: Optional[Path | str] = None) -> list:
    """A dataset's spectral Wasserstein profile, time against frequency
    diffusion."""
    plt = _plt()
    figs = []
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
    for dataset in _unique(spectral, "Dataset"):
        sub = _where(spectral, {"Dataset": dataset})
        fig, ax = plt.subplots(figsize=(5, 4))
        for domain in ("Time", "Frequency"):
            dsub = _where(sub, {"Diffusion Domain": domain})
            if not dsub:
                continue
            keys, means, _ = groupby_mean_std(dsub, ["Frequency"], ["Spectral Density"])
            ax.plot([k[0] for k in keys], means[:, 0], label=f"{domain} diff.")
        ax.set_yscale("log")
        ax.set_xlabel("Normalized frequency")
        ax.set_ylabel("Wasserstein distance on spectral density")
        ax.set_title(dataset)
        ax.legend()
        fig.tight_layout()
        if output_dir is not None:
            name = f"spectral_density_{dataset.lower().replace('-', '_')}.pdf"
            fig.savefig(output_dir / name, bbox_inches="tight")
            plt.close(fig)
        figs.append(fig)
    return figs


def create_summary_table(
    metrics: Rows,
    metric_name: str = "Sliced Wasserstein",
    output_dir: Optional[Path | str] = None,
) -> Grid:
    """The mean and sem pivot per (Dataset, Metric Domain) × Diffusion
    Domain, rounded to 3 decimals (``<metric>_summary.csv``), and its
    mean ± 2·sem cells as LaTeX (``<metric>.tex``) in ``output_dir``."""
    sub = [r for r in metrics if r["Metric"] == metric_name]
    if not sub:
        raise ValueError(f"No data found for metric: {metric_name}")
    index, column = ["Dataset", "Metric Domain"], "Diffusion Domain"
    pivot = concat_blocks([pivot_table(sub, index, column, "Value", kahan_mean),
                           pivot_table(sub, index, column, "Value", sem)], ["mean", "sem"])
    pivot.values = np.round(pivot.values, 3)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        stem = metric_name.lower().replace(" ", "_")
        write_grid_csv(pivot, output_dir / f"{stem}_summary.csv")
        (output_dir / f"{stem}.tex").write_text(grid_latex(_formatted(pivot)))
    return pivot


def _formatted(pivot: Grid) -> Grid:
    """``"$" + mean.astype(str) + r" \\ \\pm \\ " + (2 * sem).round(3)
    .astype(str) + "$"``: the two blocks aligned on their sorted union of
    columns, a cell missing where either side is."""
    mean, spread = pivot.block("mean"), pivot.block("sem")
    columns = sorted(set(mean.columns) | set(spread.columns))
    cells = np.full((len(pivot.rows), len(columns)), None, dtype=object)
    for j, col in enumerate(columns):
        for i in range(len(pivot.rows)):
            m = float_text(mean.values[i, mean.columns.index(col)]) \
                if col in mean.columns else None
            s = float_text(np.round(2 * spread.values[i, spread.columns.index(col)], 3)) \
                if col in spread.columns else None
            if m is not None and s is not None:
                cells[i, j] = f"${m} \\ \\pm \\ {s}$"
    return Grid(pivot.index_names, pivot.rows, mean.column_names, columns, cells)


def results_main(
    run_ids: list[str],
    runs_dir: Path | str,
    output_dir: Path | str,
) -> tuple[Rows, Rows]:
    """The whole results pipeline: metrics and baselines CSVs → quality
    boxes → summary tables → spectral profiles."""
    output_dir = Path(output_dir)
    metrics, baselines = process_run_metrics(run_ids, runs_dir, output_dir)
    plot_quality_boxes(metrics, baselines, output_dir / "figures")
    for metric in _unique(metrics, "Metric"):
        create_summary_table(metrics, metric, output_dir / "tables")
    try:
        spectral = process_spectral_analysis(run_ids, runs_dir, output_dir)
        plot_run_spectral_density(spectral, output_dir / "figures")
    except ValueError:
        pass
    return metrics, baselines
