"""Benchmark figure families (port of ``fdtpu/viz/benchmark_figures.py``).

Five families from the cache benchmark's rows (``fdtpu_torch.cli.
benchmark_cache``): speedup bars, time bars, cache-hit against speedup,
per-parameter ablation panels, and a colour-coded summary table; and the
speedup-per-dataset-shape bars.  matplotlib (Agg) is imported when a figure
is drawn; the figures are saved as PDF and PNG.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any, Optional

import numpy as np

from fdtpu_torch.utils.tables import column_names

Rows = list[dict[str, Any]]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


#: sweep-arm name → (parameter, numeric value), e.g. "score_R20" → ("R", 20)
_SWEEP_RE = re.compile(
    r"^(?:score_R(?P<R>[\d.]+)|score_tau(?P<tau_0>[\d.]+)"
    r"|kv_K(?P<K>[\d.]+)|token_b(?P<token_budget>[\d.]+))$"
)


def _num(v: Any) -> float:
    return math.nan if v is None else float(v)


def parse_sweep_params(rows: Rows) -> Rows:
    """The rows with ``Parameter`` and ``Value`` read off each sweep arm's
    method name (None and NaN for another arm)."""
    out = []
    for row in rows:
        m = _SWEEP_RE.match(str(row["method"]))
        key = next((k for k, v in m.groupdict().items() if v is not None), None) if m else None
        out.append({**row, "Parameter": key,
                    "Value": float(m.group(key)) if key else math.nan})
    return out


def _sorted_by(rows: Rows, name: str) -> Rows:
    """``sort_values(name)`` on rows holding a number there (numpy's
    quicksort, as pandas takes it)."""
    order = np.argsort(np.array([_num(r[name]) for r in rows]), kind="quicksort")
    return [rows[i] for i in order]


def _save(fig, figures_dir: Path, stem: str) -> None:
    fig.savefig(figures_dir / f"{stem}.pdf", bbox_inches="tight")
    fig.savefig(figures_dir / f"{stem}.png", dpi=150, bbox_inches="tight")


def create_benchmark_figures(
    rows: Rows,
    output_dir: Path | str,
    model_id: str = "model",
    hit_ratio_col: str = "cache_cache_hit_ratio",
) -> list[Path]:
    """Draw the five figure families into ``output_dir/figures``; returns
    the written figures' paths."""
    plt = _plt()
    figures_dir = Path(output_dir) / "figures"
    figures_dir.mkdir(parents=True, exist_ok=True)
    rows = parse_sweep_params(rows)
    columns = column_names(rows)
    written: list[Path] = []

    def present(r, name):
        return not math.isnan(_num(r.get(name)))

    # 1. Speedup comparison
    sub = _sorted_by([r for r in rows if r["method"] != "baseline" and present(r, "speedup")],
                     "speedup")
    if sub:
        fig, ax = plt.subplots(figsize=(9, max(3, 0.4 * len(sub))))
        speedups = [r["speedup"] for r in sub]
        colors = ["tab:green" if s > 1.0 else "tab:red" for s in speedups]
        ax.barh([r["method"] for r in sub], speedups, color=colors)
        ax.axvline(1.0, color="black", ls="--", lw=1, label="baseline (1.0x)")
        ax.set_xlabel("Speedup (x)")
        ax.set_title(f"Cache performance comparison — {model_id}")
        ax.legend()
        ax.grid(axis="x", alpha=0.3)
        fig.tight_layout()
        _save(fig, figures_dir, f"speedup_comparison_{model_id}")
        plt.close(fig)
        written.append(figures_dir / f"speedup_comparison_{model_id}.pdf")

    # 2. Time comparison
    sub = _sorted_by([r for r in rows if present(r, "time_s")], "time_s")
    if sub:
        fig, ax = plt.subplots(figsize=(9, max(3, 0.4 * len(sub))))
        colors = ["tab:blue" if r["method"] == "baseline" else "tab:orange" for r in sub]
        ax.barh([r["method"] for r in sub], [r["time_s"] for r in sub], color=colors)
        ax.set_xlabel("Time (s)")
        ax.set_title(f"Sampling time comparison — {model_id}")
        ax.grid(axis="x", alpha=0.3)
        fig.tight_layout()
        _save(fig, figures_dir, f"time_comparison_{model_id}")
        plt.close(fig)
        written.append(figures_dir / f"time_comparison_{model_id}.pdf")

    # 3. Cache-hit ratio against speedup
    if hit_ratio_col in columns:
        sub = [r for r in rows if r["method"] != "baseline" and present(r, hit_ratio_col)
               and present(r, "speedup")]
        if sub:
            fig, ax = plt.subplots(figsize=(6.5, 4.5))
            sc = ax.scatter([r[hit_ratio_col] for r in sub], [r["speedup"] for r in sub],
                            s=80, alpha=0.7, c=[_num(r.get("time_s")) for r in sub],
                            cmap="viridis_r")
            ax.set_xlabel("Cache hit ratio")
            ax.set_ylabel("Speedup (x)")
            ax.set_title(f"Cache hit ratio vs speedup — {model_id}")
            ax.grid(alpha=0.3)
            fig.colorbar(sc, ax=ax, label="Time (s)")
            fig.tight_layout()
            _save(fig, figures_dir, f"cache_hit_vs_speedup_{model_id}")
            plt.close(fig)
            written.append(figures_dir / f"cache_hit_vs_speedup_{model_id}.pdf")

    # 4. Per-parameter ablation panels
    for param in ("K", "R", "tau_0", "token_budget"):
        sub = _sorted_by([r for r in rows if r["Parameter"] == param], "Value")
        if not sub:
            continue
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 3.8))
        values = [r["Value"] for r in sub]
        ax1.plot(values, [_num(r.get("speedup")) for r in sub], marker="o")
        ax1.axhline(1.0, color="black", ls="--", lw=1, alpha=0.5)
        ax1.set_xlabel(param)
        ax1.set_ylabel("Speedup (x)")
        ax1.set_title(f"Speedup vs {param}")
        ax1.grid(alpha=0.3)
        ycol = hit_ratio_col if hit_ratio_col in columns else "speedup"
        ax2.plot(values, [_num(r.get(ycol)) for r in sub], marker="s", color="tab:orange")
        ax2.set_xlabel(param)
        ax2.set_ylabel("Cache hit ratio")
        ax2.set_ylim(0, 1.1)
        ax2.set_title(f"Cache hit ratio vs {param}")
        ax2.grid(alpha=0.3)
        fig.tight_layout()
        _save(fig, figures_dir, f"ablation_{param.lower()}_{model_id}")
        plt.close(fig)
        written.append(figures_dir / f"ablation_{param.lower()}_{model_id}.pdf")

    # 5. Summary table: a float column rounded to 3 decimals, a gap blank.
    cols = [c for c in ("method", "time_s", "speedup", hit_ratio_col,
                        "cache_steps_skipped_ratio", "sw_vs_baseline") if c in columns]

    def cell(v):
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return ""
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(np.round(v, 3))
        return v

    table_rows = [[cell(r.get(c)) for c in cols] for r in rows]
    fig, ax = plt.subplots(figsize=(11, 0.4 * len(table_rows) + 1.5))
    ax.axis("off")
    table = ax.table(cellText=table_rows, colLabels=[c.replace("cache_", "") for c in cols],
                     cellLoc="center", loc="center")
    table.auto_set_font_size(False)
    table.set_fontsize(8)
    table.scale(1, 1.4)
    for i, r in enumerate(rows):
        color: Optional[str] = None
        if r["method"] == "baseline":
            color = "#ecf0f1"
        elif "speedup" in cols and _num(r.get("speedup")) > 1.0:
            color = "#e8f8f5"
        if color:
            for j in range(len(cols)):
                table[(i + 1, j)].set_facecolor(color)
    ax.set_title(f"Cache benchmark summary — {model_id}", pad=12)
    _save(fig, figures_dir, f"summary_table_{model_id}")
    plt.close(fig)
    written.append(figures_dir / f"summary_table_{model_id}.pdf")
    return written


def shape_scaling_figure(
    payload: dict, output_dir: Path | str, stem: str = "shape_scaling"
) -> Optional[Path]:
    """Speedup bars per dataset shape from a ``shape_scaling.json``
    payload, against the reference paper's 3.2× average (its §4.1, measured
    on a CPU at batch 1).  Returns the written PDF's path, or None if no
    shape has a speedup."""
    shapes = {name: entry for name, entry in payload.get("shapes", {}).items()
              if entry.get("speedup") is not None}
    if not shapes:
        return None
    plt = _plt()
    figures_dir = Path(output_dir) / "figures"
    figures_dir.mkdir(parents=True, exist_ok=True)
    names = sorted(shapes, key=lambda n: shapes[n]["speedup"])
    labels = [f"{n}\n({shapes[n]['max_len']}x{shapes[n]['n_channels']})" for n in names]
    speedups = [shapes[n]["speedup"] for n in names]
    skipped = [shapes[n].get("steps_skipped_ratio") for n in names]
    fig, ax = plt.subplots(figsize=(8, 4.5))
    bars = ax.bar(labels, speedups, color="tab:green", alpha=0.85)
    for bar, sp, sk in zip(bars, speedups, skipped):
        note = f"{sp:.1f}x" + (f"\n{100 * sk:.0f}% skip" if sk is not None else "")
        ax.annotate(note, (bar.get_x() + bar.get_width() / 2, bar.get_height()),
                    ha="center", va="bottom", fontsize=8)
    ax.axhline(3.2, color="tab:gray", ls="--", lw=1, label="reference paper avg (3.2x, CPU)")
    ax.axhline(1.0, color="black", ls=":", lw=1)
    ax.set_ylabel("E2-CRF speedup over uncached (x)")
    ax.set_ylim(0, max(speedups) * 1.2)
    ax.set_title("E2-CRF speedup across the five reference dataset shapes")
    ax.legend()
    ax.grid(axis="y", alpha=0.3)
    fig.tight_layout()
    _save(fig, figures_dir, stem)
    plt.close(fig)
    return figures_dir / f"{stem}.pdf"
