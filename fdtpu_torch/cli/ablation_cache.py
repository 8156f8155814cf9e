"""E²-CRF ablation CLI of the port (port of ``cli/ablation_cache.py``).

Usage:
    python -m fdtpu_torch.cli.ablation_cache model_id=latest [num_samples=..]

Runs the ablation arms of the paper's Tables 3 and 4 against a trained run:
the uncached baseline and its noise floor (a rerun with another seed), the
score level with each of its mechanisms turned off, the FreqCa predictor,
the token level with each knob turned off, the KV level's macro policy and
its event policy over a τ₀ sweep.  Each arm is the median of three timed
runs after a warm-up, with its speedup and its sliced Wasserstein distance
to the baseline's samples.  Writes ``ablation_results/ablation_results.json``
and ``ablation_results/ablation_sweep.csv`` under the working directory and
prints a summary table.  The samplers run at ``batches_per_call=1``, the JAX
CLI's default: the eager per-step loop.  It runs on the CUDA card;
``+device=cpu`` runs it on the CPU.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from fdtpu_torch.metrics import SlicedWasserstein
from fdtpu_torch.sampling import DiffusionSampler
from fdtpu_torch.train import get_best_checkpoint, load_checkpoint
from fdtpu_torch.utils.builders import resolve_model_dir
from fdtpu_torch.utils.config import CONFIG_DIR, compose_config
from fdtpu_torch.utils.device import resolve_device
from fdtpu_torch.utils.profiling import block_until_ready
from fdtpu_torch.utils.tables import write_csv

OUT_DIR = Path("ablation_results")

ABLATIONS: list[tuple[str, dict]] = [
    ("baseline", {}),
    # An uncached rerun with another seed: its distance to the baseline's
    # samples is the noise floor every other arm's is read against.
    ("baseline_rerun_floor", {"_sample_seed": 4242}),
    # --- score level (whole-step skipping)
    ("full_e2crf", dict(use_cache=True, cache_kwargs={"level": "score", "policy": "event", "R": 100, "tau_0": 1.0, "eps_order": 1})),
    ("no_extrapolation", dict(use_cache=True, cache_kwargs={"level": "score", "R": 100, "tau_0": 1.0, "eps_order": 0})),
    ("no_event_trigger", dict(use_cache=True, cache_kwargs={"level": "score", "R": 10, "tau_0": 1e9})),
    ("no_error_feedback", dict(use_cache=True, cache_kwargs={"level": "score", "R": 999999, "tau_0": 1e9})),
    # FreqCa as the ε̂ predictor: the frozen low-frequency part and a Hermite
    # extrapolation of the high-frequency part over the refresh ring.
    ("freqca_predictor", dict(use_cache=True, cache_kwargs={"level": "score", "R": 100, "tau_0": 1.0, "eps_predictor": "freqca"})),
    ("freqca_predictor_h1", dict(use_cache=True, cache_kwargs={"level": "score", "R": 100, "tau_0": 1.0, "eps_predictor": "freqca", "hermite_order": 1})),
    # --- token level (top-k recompute a step), each knob off in turn
    ("token_full", dict(use_cache=True, cache_kwargs={"level": "token", "token_budget": 24, "tau_0": 0.5, "R": 100})),
    ("token_no_skip", dict(use_cache=True, cache_kwargs={"level": "token", "token_budget": 24, "tau_0": 0.0, "R": 100})),
    ("token_no_energy_weighting", dict(use_cache=True, cache_kwargs={"level": "token", "token_budget": 24, "tau_0": 0.0, "R": 100, "energy_weighting": False})),
    ("token_no_extrapolation", dict(use_cache=True, cache_kwargs={"level": "token", "token_budget": 24, "tau_0": 0.0, "R": 100, "eps_order": 0})),
    ("token_random_probe", dict(use_cache=True, cache_kwargs={"level": "token", "token_budget": 24, "tau_0": 0.0, "R": 100, "random_probe_ratio": 0.05})),
    # --- KV level (the reference's mechanism)
    ("naive_caching", dict(use_cache=True, cache_kwargs={"level": "kv", "policy": "macro"})),
]

# The KV event policy's τ₀ sweep, to the operating point where it reaches
# CACHED steps.  K = 0 (K low-frequency anchors force MIXED every step) and
# τ_warn = ∞ (the mean CRF drift is unnormalized) make a CACHED step
# reachable; the drift's scale depends on the model, so τ₀ is log-spaced.
KV_TAU_SWEEP = (1.0, 10.0, 100.0, 1000.0)


def kv_event_arm(tau: float) -> dict:
    return dict(
        use_cache=True,
        cache_kwargs={
            "level": "kv", "policy": "event", "K": 0, "R": 100,
            "tau_0": tau, "tau_warn": 1e9,
        },
    )


def arms() -> list[tuple[str, dict]]:
    return list(ABLATIONS) + [(f"kv_event_tau{tau:g}", kv_event_arm(tau)) for tau in KV_TAU_SWEEP]


def sweep_rows(results: dict[str, dict]) -> list[dict[str, Any]]:
    """The tidy rows of ``ablation_sweep.csv`` (the Tables 3/4 shape)."""
    rows = []
    for name, entry in results.items():
        stats = entry.get("cache_stats", {})
        rows.append({
            "config": name,
            "time_s": entry["time_s"],
            "speedup": entry.get("speedup", 1.0),
            "sw_vs_baseline": entry.get("sw_vs_baseline"),
            "steps_skipped_ratio": stats.get("steps_skipped_ratio", 0.0),
            "cache_hit_ratio": stats.get("cache_hit_ratio", 0.0),
            "full_steps": stats.get("full_steps"),
            "topk_steps": stats.get("mixed_steps"),
        })
    return rows


def main(argv: Optional[list[str]] = None) -> dict[str, dict]:
    """Compose ``configs/sample.yaml`` with ``argv`` (default
    ``sys.argv[1:]``), run every arm, write the JSON and CSV; returns the
    results by arm."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", force=True)
    cfg = compose_config(CONFIG_DIR, "sample", sys.argv[1:] if argv is None else list(argv))
    device = resolve_device(cfg.get("device"))

    model_dir = resolve_model_dir(cfg["model_path"], cfg["model_id"])
    ckpt = get_best_checkpoint(model_dir / "checkpoints")
    logging.info("Ablating checkpoint %s", ckpt)
    overrides = {"attention_impl": cfg["attention_impl"]} if cfg.get("attention_impl") else {}
    model = load_checkpoint(ckpt, device=device, **overrides)

    num_samples = int(cfg["num_samples"])
    steps = int(cfg["num_diffusion_steps"])
    batch = int(cfg["sampler"]["sample_batch_size"])

    results: dict[str, dict] = {}
    baseline_time = None
    sw_metric = None
    for name, kw in arms():
        kw = dict(kw)
        sample_seed = kw.pop("_sample_seed", 42)
        budget = (kw.get("cache_kwargs") or {}).get("token_budget")
        if budget is not None and budget >= model.max_len:
            logging.info("skipping %s: token_budget %s >= max_len %s", name, budget,
                         model.max_len)
            continue
        sampler = DiffusionSampler(model, sample_batch_size=batch, **kw)
        block_until_ready(sampler.sample(
            min(batch, num_samples), steps, generator=torch.Generator(device=device).manual_seed(0)))
        times = []
        for _ in range(3):  # the median of three
            sampler.last_cache_state = None
            t0 = time.perf_counter()
            samples = block_until_ready(sampler.sample(
                num_samples, steps, generator=torch.Generator(device=device).manual_seed(sample_seed)))
            times.append(time.perf_counter() - t0)
        elapsed = float(np.median(times))
        entry: dict[str, Any] = {
            "time_s": round(elapsed, 4),
            "samples_per_s": round(samples.shape[0] / elapsed, 2),
        }
        if baseline_time is None:
            baseline_time = elapsed
            sw_metric = SlicedWasserstein(original_samples=samples, random_seed=42,
                                          num_directions=200)
        else:
            entry["speedup"] = round(baseline_time / elapsed, 3)
            entry["sw_vs_baseline"] = sw_metric(samples)["sliced_wasserstein_mean"]
        if kw.get("use_cache"):
            entry["cache_stats"] = sampler.get_cache_stats()
        results[name] = entry
        logging.info("%-22s %s", name, json.dumps(entry))

    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "ablation_results.json", "w") as f:
        json.dump(results, f, indent=2)
    logging.info("Wrote %s", OUT_DIR / "ablation_results.json")
    write_csv(sweep_rows(results), OUT_DIR / "ablation_sweep.csv")
    logging.info("Wrote %s", OUT_DIR / "ablation_sweep.csv")

    print(f"\n{'config':<24}{'time (s)':>10}{'speedup':>10}{'skipped':>10}{'SW':>12}")
    for name, entry in results.items():
        skipped = entry.get("cache_stats", {}).get("steps_skipped_ratio", 0.0)
        print(
            f"{name:<24}{entry['time_s']:>10.3f}{entry.get('speedup', 1.0):>10.2f}"
            f"{skipped:>10.2f}{entry.get('sw_vs_baseline', float('nan')):>12.4f}"
        )
    return results


if __name__ == "__main__":
    main()
