"""E²-CRF cache benchmark CLI of the port (port of ``cli/benchmark_cache.py``).

Usage:
    python -m fdtpu_torch.cli.benchmark_cache model_id=latest [num_samples=..]
    python -m fdtpu_torch.cli.benchmark_cache model_id=latest run_ablations=false

Times uncached against cached (and cached with FreSca) sampling on a trained
run and sweeps the cache's knobs (R, τ₀, K, the token budget), each arm the
median of three timed runs after a warm-up, with its sliced Wasserstein
distance to the uncached samples beside the noise floor of a second
uncached run; writes ``outputs/cache_benchmark/benchmark_results.csv`` under
the working directory, and its five figure families under ``figures/``
beside it where matplotlib is installed (a warning where they cannot be
drawn, as on a machine without matplotlib).  The samplers run at
``batches_per_call=1``, the JAX CLI's default: the eager per-step loop.  It
runs on the CUDA card; ``+device=cpu`` runs it on the CPU.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from fdtpu_torch.metrics import SlicedWasserstein
from fdtpu_torch.models.score_models import ScoreModel
from fdtpu_torch.sampling import DiffusionSampler
from fdtpu_torch.train import get_best_checkpoint, load_checkpoint
from fdtpu_torch.utils.builders import resolve_model_dir
from fdtpu_torch.utils.config import CONFIG_DIR, compose_config
from fdtpu_torch.utils.device import module_device, resolve_device
from fdtpu_torch.utils.profiling import block_until_ready
from fdtpu_torch.utils.tables import write_csv
from fdtpu_torch.viz.benchmark_figures import create_benchmark_figures

OUT_DIR = Path("outputs/cache_benchmark")

# The score and token arms' operating points (bench.py CACHE_KWARGS,
# docs/benchmarks/token_level.md); the sweeps cover the rest.
SCORE_KWARGS = {"level": "score", "R": 100, "tau_0": 1.0, "eps_order": 1}
HEADLINE: list[tuple[str, dict]] = [
    ("e2crf_score", dict(use_cache=True, cache_kwargs=dict(SCORE_KWARGS))),
    ("e2crf_token", dict(use_cache=True, cache_kwargs={
        "level": "token", "token_budget": 24, "tau_0": 0.5, "R": 100})),
    ("e2crf_kv_event", dict(use_cache=True, cache_kwargs={
        "level": "kv", "policy": "event", "K": 5, "R": 10})),
    ("e2crf_kv_macro", dict(use_cache=True, cache_kwargs={
        "level": "kv", "policy": "macro", "K": 5, "R": 10})),
    ("e2crf_score_fresca", dict(use_cache=True, cache_kwargs=dict(SCORE_KWARGS),
                                use_fresca=True, fresca_kwargs={"fresca_high_scale": 1.5})),
]


def sweep_arms(max_len: int) -> list[tuple[str, dict]]:
    """The hyperparameter sweeps, in the JAX CLI's order."""
    # R at τ₀ = ∞: the fixed R-periodic schedule alone.
    arms = [(f"score_R{r}", dict(use_cache=True, cache_kwargs={
        "level": "score", "R": r, "tau_0": 1e9})) for r in (5, 10, 20, 50)]
    # τ₀ over the usable range, past where the deviation leaves the floor.
    arms += [(f"score_tau{tau}", dict(use_cache=True, cache_kwargs={
        "level": "score", "R": 20, "tau_0": tau}))
        for tau in (0.01, 0.05, 0.1, 0.5, 1.0, 2.0, 5.0, 20.0)]
    arms += [(f"kv_K{k}", dict(use_cache=True, cache_kwargs={
        "level": "kv", "policy": "event", "K": k, "R": 10})) for k in (0, 3, 5, 10)]
    arms += [(f"token_b{b}", dict(use_cache=True, cache_kwargs={
        "level": "token", "token_budget": b, "tau_0": 0.0, "R": 100}))
        for b in (16, 24, 48) if b < max_len]
    return arms


def benchmark_sampling(
    model: ScoreModel,
    num_samples: int,
    num_diffusion_steps: int,
    sample_batch_size: int,
    use_cache: bool = False,
    cache_kwargs: Optional[dict] = None,
    use_fresca: bool = False,
    fresca_kwargs: Optional[dict] = None,
    warmup: bool = True,
    seed: int = 42,
    repeats: int = 3,
) -> dict[str, Any]:
    """A warm-up run, then the median of ``repeats`` timed runs, each
    timed up to its samples being on the device."""
    sampler = DiffusionSampler(
        model,
        sample_batch_size=sample_batch_size,
        use_cache=use_cache,
        cache_kwargs=cache_kwargs or {},
        use_fresca=use_fresca,
        **(fresca_kwargs or {}),
    )
    device = module_device(model.network)
    if warmup:
        block_until_ready(sampler.sample(
            min(sample_batch_size, num_samples), num_diffusion_steps,
            generator=torch.Generator(device=device).manual_seed(0)))
        sampler.last_cache_state = None

    times = []
    for _ in range(repeats):
        sampler.last_cache_state = None
        t0 = time.perf_counter()
        samples = block_until_ready(sampler.sample(
            num_samples, num_diffusion_steps,
            generator=torch.Generator(device=device).manual_seed(seed)))
        times.append(time.perf_counter() - t0)
    elapsed = float(np.median(times))
    result: dict[str, Any] = {
        "time_s": elapsed,
        "samples_per_s": samples.shape[0] / elapsed,
        "num_samples": samples.shape[0],
        "num_diffusion_steps": num_diffusion_steps,
    }
    if use_cache:
        result.update({f"cache_{k}": v for k, v in sampler.get_cache_stats().items()})
    result["_samples"] = samples
    return result


def main(argv: Optional[list[str]] = None) -> list[dict[str, Any]]:
    """Compose ``configs/sample.yaml`` with ``argv`` (default
    ``sys.argv[1:]``), benchmark, write the CSV; returns its rows."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", force=True)
    cfg = compose_config(CONFIG_DIR, "sample", sys.argv[1:] if argv is None else list(argv))
    device = resolve_device(cfg.get("device"))

    model_dir = resolve_model_dir(cfg["model_path"], cfg["model_id"])
    ckpt = get_best_checkpoint(model_dir / "checkpoints")
    logging.info("Benchmarking checkpoint %s", ckpt)
    overrides = {"attention_impl": cfg["attention_impl"]} if cfg.get("attention_impl") else {}
    model = load_checkpoint(ckpt, device=device, **overrides)

    num_samples = int(cfg["num_samples"])
    steps = int(cfg["num_diffusion_steps"])
    batch = int(cfg["sampler"]["sample_batch_size"])
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    rows: list[dict[str, Any]] = []

    def record(name: str, res: dict[str, Any], baseline_time: Optional[float]) -> None:
        row = {"method": name, **{k: v for k, v in res.items() if k != "_samples"}}
        if baseline_time is not None:
            row["speedup"] = baseline_time / res["time_s"]
        rows.append(row)
        logging.info(
            "%-28s %7.3fs  %8.1f samples/s  speedup %.2fx  skipped %.0f%%",
            name, res["time_s"], res["samples_per_s"], row.get("speedup", 1.0),
            100 * res.get("cache_steps_skipped_ratio", 0.0),
        )

    baseline = benchmark_sampling(model, num_samples, steps, batch)
    record("baseline", baseline, None)
    t_base = baseline["time_s"]

    sw = SlicedWasserstein(original_samples=baseline["_samples"], random_seed=42,
                           num_directions=200)
    # The finite-sample noise floor: a second uncached run with another seed.
    base2 = benchmark_sampling(model, num_samples, steps, batch, seed=4242, warmup=False,
                               repeats=1)
    base2["sw_vs_baseline"] = sw(base2["_samples"])["sliced_wasserstein_mean"]
    record("baseline_self(noise floor)", base2, t_base)

    arms = list(HEADLINE)
    if cfg.get("run_ablations", True):
        arms += sweep_arms(model.max_len)
    for name, kw in arms:
        budget = (kw.get("cache_kwargs") or {}).get("token_budget")
        if budget is not None and budget >= model.max_len:
            logging.info("skipping %s: token_budget %s >= max_len %s",
                         name, budget, model.max_len)
            continue
        res = benchmark_sampling(model, num_samples, steps, batch, **kw)
        res["sw_vs_baseline"] = sw(res["_samples"])["sliced_wasserstein_mean"]
        record(name, res, t_base)

    csv_path = OUT_DIR / "benchmark_results.csv"
    write_csv(rows, csv_path)
    logging.info("Wrote %s", csv_path)
    try:
        written = create_benchmark_figures(
            rows, OUT_DIR, model_id=str(cfg.get("model_id") or model_dir.name))
        logging.info("Wrote %d figure families to %s", len(written), OUT_DIR / "figures")
    except Exception as exc:  # drawing is best-effort, as in the JAX CLI
        logging.warning("Figure generation failed: %s", exc)
    return rows


if __name__ == "__main__":
    main()
