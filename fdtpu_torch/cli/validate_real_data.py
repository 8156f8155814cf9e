"""Table-2 real-data harness of the port (port of
``scripts/validate_real_data.py``).

Runs the reference quality protocol on one dataset, or on all of them:
prepare → train (time and frequency domains) → sample (uncached baseline and
E²-CRF cached) → Wasserstein metrics, through the port's train and sample
CLIs, and writes ``outputs/table2_torch/table2_<dataset>.json`` under the
working directory after each step, in the JAX harness's layout (paper Table
2, p.8).  Raw files are read from ``--data-dir`` (default ``data``); see
:mod:`fdtpu_torch.data.fixtures` for their schemas:

  ecg            <data-dir>/ecg/mitbih_{train,test}.csv        (Kaggle shayanfazeli/heartbeat)
  nasdaq         <data-dir>/nasdaq/stocks/*.csv                (Kaggle jacksoncrow/stock-market-dataset)
  nasa_charge    <data-dir>/nasa/cleaned_dataset/{metadata.csv,data/*.csv}
  nasa_discharge (same files as nasa_charge)                   (Kaggle patrickfleith/nasa-battery-dataset)
  droughts       <data-dir>/droughts/train_timeseries/train_timeseries.csv
                                                               (Kaggle cdminix/us-drought-meteorological-data)
  mimic          <data-dir>/mimiciii/all_hourly_data.h5        (MIMIC-Extract, restricted)
  synthetic      nothing (generated)

``--fixture`` writes the schema fixtures first (plumbing only: their metric
numbers mean nothing); MIMIC's is its ``.h5`` where h5py is installed and
else its prepared ``.npy`` form (logged, and recorded in the JSON's
``protocol.fixture_form``).  ``--smoke`` shrinks the model and the protocol.
It runs on the CUDA card; ``--device cpu`` runs it on the CPU.  Besides the
JAX harness's keys, ``protocol`` records the device and the training-set
size, and the times are not rounded.

Usage:
  python -m fdtpu_torch.cli.validate_real_data ecg --data-dir data
  python -m fdtpu_torch.cli.validate_real_data all --fixture --smoke --domains frequency
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import sys
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np

from fdtpu_torch.cli import sample as sample_cli
from fdtpu_torch.cli import train as train_cli
from fdtpu_torch.data import fixtures
from fdtpu_torch.utils import yaml_subset
from fdtpu_torch.utils.config import CONFIG_DIR, compose_config

# dataset key → (config datamodule group, extra train overrides,
#                 (fixture writer, writer kwargs))
DATASETS = {
    "ecg": ("ecg", [], ("write_ecg_fixture", {})),
    "nasdaq": ("nasdaq", [], ("write_nasdaq_fixture", {})),
    "nasa_charge": ("nasa", ["datamodule.subdataset=charge"],
                    ("write_nasa_fixture", {"kind": "charge"})),
    "nasa_discharge": ("nasa", ["datamodule.subdataset=discharge"],
                       ("write_nasa_fixture", {"kind": "discharge"})),
    "droughts": ("usdroughts", [], ("write_droughts_fixture", {})),
    "mimic": ("mimiciii", [], ("write_mimic_fixture", {})),
    "synthetic": ("synthetic", [], None),
}

# Paper Table 2 (p.8): time-domain sliced Wasserstein, baseline against
# E²-CRF cached, mean ± std.
REFERENCE_TABLE2 = {
    "ecg": {"baseline_sw": [0.015, 0.000], "cached_sw": [0.015, 0.000]},
    "nasdaq": {"baseline_sw": [43.602, 2.044], "cached_sw": [44.215, 2.078]},
    "nasa_charge": {"baseline_sw": [0.229, 0.008], "cached_sw": [0.232, 0.008]},
    "nasa_discharge": {"baseline_sw": [2.028, 0.082], "cached_sw": [2.056, 0.084]},
    "droughts": {"baseline_sw": [0.738, 0.020], "cached_sw": [0.746, 0.020]},
}

# The validated cached operating point (bench.py's CACHE_KWARGS).
CACHED_KWARGS = {"level": "score", "R": 100, "tau_0": 1.35, "eps_order": 1}

OUT_DIR = Path("outputs/table2_torch")


def _metric_rows(results: dict) -> dict:
    """Table-2-shaped rows of a ``MetricCollection`` result dict."""
    rows = {}
    for domain_prefix in ("time_", "freq_", "spectral_"):
        for stem in ("sliced_wasserstein", "marginal_wasserstein"):
            key = f"{domain_prefix}{stem}_mean"
            if key in results:
                rows[key] = results[key]
            all_key = f"{domain_prefix}{stem}_all"
            if all_key in results:
                rows[f"{domain_prefix}{stem}_std"] = float(np.std(results[all_key]))
        floor = f"{domain_prefix}sliced_wasserstein_mean_self"
        if floor in results:
            rows[floor] = results[floor]
    return rows


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m fdtpu_torch.cli.validate_real_data")
    parser.add_argument("dataset", choices=sorted(DATASETS) + ["all"])
    parser.add_argument("--data-dir", type=Path, default=Path("data"))
    parser.add_argument("--run-dir", type=Path, default=None,
                        help="training run dir (default lightning_logs)")
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--num-samples", type=int, default=1000)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--sample-batch", type=int, default=128)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--domains", nargs="+", default=["frequency", "time"],
                        choices=["time", "frequency"])
    parser.add_argument("--fixture", action="store_true",
                        help="write schema fixtures into --data-dir first "
                             "(plumbing proof; metric numbers meaningless)")
    parser.add_argument("--override", action="append", default=[],
                        help="extra train overrides (e.g. datamodule.num_samples=4000); "
                             "recorded in the output protocol block")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny model + 1 epoch + few steps (CI)")
    parser.add_argument("--device", default="cuda",
                        help="where to train and sample (cuda or cpu)")
    return parser.parse_args(argv)


def main(argv: Optional[list[str]] = None) -> int:
    """Run the harness on ``argv`` (default ``sys.argv[1:]``); prints the
    summary JSON and returns the exit code (1 if a dataset of ``all``
    failed)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", force=True)
    if args.dataset != "all":
        print(json.dumps(run_dataset(args)))
        return 0
    # The whole sweep: one table2_<dataset>.json each; with --fixture --smoke
    # the complete Table-2 plumbing, so staged raw files are a drop-in.
    summaries, failures = {}, 0
    for ds in sorted(DATASETS):
        sub = argparse.Namespace(**vars(args))
        sub.dataset = ds
        sub.out = None
        try:
            summaries[ds] = run_dataset(sub)
        except Exception as exc:  # keep sweeping; surface at the end
            logging.exception("[%s] FAILED", ds)
            summaries[ds] = {"error": f"{type(exc).__name__}: {exc}"}
            failures += 1
    print(json.dumps(summaries))
    return 1 if failures else 0


def _write_fixture(args: argparse.Namespace, fixture_writer) -> Optional[str]:
    """Write the dataset's fixture tree; returns the form MIMIC's took."""
    writer_name, writer_kwargs = fixture_writer
    if writer_name == "write_mimic_fixture" and importlib.util.find_spec("h5py") is None:
        from fdtpu_torch.data.preprocessing import mimic_preprocess_frames

        logging.warning("h5py is not installed: MIMIC's fixture is written in its prepared "
                        ".npy form, so the .h5 reader is not exercised")
        path = Path(args.data_dir) / "mimiciii"
        path.mkdir(parents=True, exist_ok=True)
        mimic_preprocess_frames(*fixtures.mimic_fixture_tables(), path, random_seed=args.seed)
        form = "npy"
    else:
        path = getattr(fixtures, writer_name)(args.data_dir, **writer_kwargs)
        form = "h5" if writer_name == "write_mimic_fixture" else None
    logging.info("wrote %s fixture into %s", args.dataset, path)
    return form


def run_dataset(args: argparse.Namespace) -> dict[str, Any]:
    group, extra, fixture_writer = DATASETS[args.dataset]
    form = None
    if args.fixture:
        if fixture_writer is None:
            logging.info("synthetic generates its own data; --fixture ignored")
        else:
            form = _write_fixture(args, fixture_writer)

    if args.smoke:
        args.epochs = min(args.epochs, 1)
        args.num_samples = min(args.num_samples, 8)
        args.steps = min(args.steps, 5)
        args.sample_batch = min(args.sample_batch, 8)

    run_root = args.run_dir or Path("lightning_logs")
    out = args.out or (OUT_DIR / f"table2_{args.dataset}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    payload: dict[str, Any] = {
        "dataset": args.dataset,
        "protocol": {
            "epochs": args.epochs, "num_samples": args.num_samples,
            "steps": args.steps, "seed": args.seed,
            "train_overrides": list(args.override),
            "cached_kwargs": CACHED_KWARGS, "fixture_data": bool(args.fixture),
            "smoke": bool(args.smoke), "device": args.device,
        },
        "reference_table2": REFERENCE_TABLE2.get(args.dataset),
        "domains": {},
    }
    if form is not None:
        payload["protocol"]["fixture_form"] = form
    if args.fixture:
        payload["warning"] = (
            "fixture data — plumbing proof only, metric numbers are "
            "meaningless; stage the real raw files for Table-2 comparisons"
        )
    smoke_overrides = ["score_model.d_model=16", "score_model.num_layers=2",
                       "score_model.n_head=4", "score_model.dim_feedforward=32"] \
        if args.smoke else []

    for domain in args.domains:
        fourier = domain == "frequency"
        run_id = f"table2_{args.dataset}_{domain}"
        train_overrides = [
            f"datamodule={group}",
            f"datamodule.data_dir={args.data_dir}",
            f"fourier_transform={'true' if fourier else 'false'}",
            "standardize=true",
            f"trainer.max_epochs={args.epochs}",
            f"run_dir={run_root}",
            f"+run_id={run_id}",
            f"random_seed={args.seed}",
            f"+device={args.device}",
            *extra,
            *smoke_overrides,
            *args.override,
        ]
        logging.info("[%s/%s] training: %s", args.dataset, domain, " ".join(train_overrides))
        t0 = time.perf_counter()
        runner = train_cli.TrainingRunner(compose_config(CONFIG_DIR, "train", train_overrides))
        runner.train()
        payload["protocol"]["train_size"] = len(runner.datamodule.X_train)
        domain_entry = {
            "run_id": run_id,
            "train_time_s": time.perf_counter() - t0,
            "best_val_loss": runner.trainer.best_val_loss,
            "arms": {},
        }
        payload["domains"][domain] = domain_entry
        out.write_text(json.dumps(payload, indent=2))

        for arm, arm_overrides in (
            ("baseline", []),
            ("cached", ["use_cache=true"]
             + [f"+cache_kwargs.{k}={v}" for k, v in CACHED_KWARGS.items()]),
        ):
            sample_overrides = [
                f"model_path={run_root}",
                f"model_id={run_id}",
                f"num_samples={args.num_samples}",
                f"num_diffusion_steps={args.steps}",
                f"+sampler.sample_batch_size={args.sample_batch}",
                f"random_seed={args.seed}",
                f"+device={args.device}",
                *arm_overrides,
            ]
            logging.info("[%s/%s] sampling %s arm", args.dataset, domain, arm)
            t0 = time.perf_counter()
            srunner = sample_cli.SamplingRunner(
                compose_config(CONFIG_DIR, "sample", sample_overrides))
            srunner.sample()
            results = yaml_subset.load(srunner.model_dir / "results.yaml")
            entry = {"sample_time_s": time.perf_counter() - t0, **_metric_rows(results)}
            if arm == "cached":
                entry["cache_stats"] = srunner.sampler.get_cache_stats()
            domain_entry["arms"][arm] = entry
            out.write_text(json.dumps(payload, indent=2))

    # The side-by-side summary row: paper Table 2 compares the TIME-domain SW
    # of the frequency-trained model's samples after the inverse DFT.
    freq = payload["domains"].get("frequency", {}).get("arms", {})
    if freq:
        payload["summary"] = {
            "fdtpu_baseline_sw": [
                freq.get("baseline", {}).get("time_sliced_wasserstein_mean"),
                freq.get("baseline", {}).get("time_sliced_wasserstein_std"),
            ],
            "fdtpu_cached_sw": [
                freq.get("cached", {}).get("time_sliced_wasserstein_mean"),
                freq.get("cached", {}).get("time_sliced_wasserstein_std"),
            ],
            "reference": REFERENCE_TABLE2.get(args.dataset),
        }
    out.write_text(json.dumps(payload, indent=2))
    logging.info("wrote %s", out)
    return payload.get("summary") or {"ok": True}


if __name__ == "__main__":
    sys.exit(main())
