"""The port's cache-study CLIs, ``fdtpu_torch.cli.ablation_cache`` and
``fdtpu_torch.cli.benchmark_cache``, and ``fdtpu_torch.utils.profiling``.

Both CLIs run in-process on the CPU (``+device=cpu``) on a tiny trained run,
from a temporary working directory.  Then each is held to its JAX CLI
(``cli/ablation_cache.py``, ``cli/benchmark_cache.py``) with the sampling
replaced by the same fake in both and the clocks by the same counter: the
same arms with the same keyword arguments in the same order, and the same
JSON, CSV and printed table, byte for byte (the JAX CLIs write their CSVs
with pandas, the port with the csv module).
"""

import importlib.util
import json
import math
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from fdtpu_torch.cli import ablation_cache, benchmark_cache
from fdtpu_torch.cli import train as train_cli
from fdtpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
SAMPLE_ARGS = ["num_samples=4", "num_diffusion_steps=4", "sampler.sample_batch_size=2"]
STEPS_RUN = 2 * 4  # two batches of four steps


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", REPO / "cli" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """A tiny run whose 26 tokens admit the token arms of budget 16 and 24."""
    tmp = tmp_path_factory.mktemp("cache_cli")
    train_cli.main(["datamodule=synthetic", f"datamodule.data_dir={tmp / 'data'}",
                    "fourier_transform=true", "datamodule.max_len=26",
                    "datamodule.num_samples=32", "trainer.max_epochs=1",
                    "score_model.d_model=8", "score_model.num_layers=1",
                    "score_model.n_head=2", "score_model.dim_feedforward=16",
                    f"run_dir={tmp / 'runs'}", "+device=cpu"])
    return tmp / "runs"


def _finite(values):
    return all(math.isfinite(v) for v in values if isinstance(v, (int, float)))


def test_ablation_cli_runs_every_arm(trained_run, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    results = ablation_cache.main([f"model_path={trained_run}", *SAMPLE_ARGS, "+device=cpu"])
    assert list(results) == [name for name, _ in ablation_cache.arms()]
    written = json.loads((tmp_path / "ablation_results/ablation_results.json").read_text())
    assert written == json.loads(json.dumps(results))
    for name, entry in results.items():
        assert entry["time_s"] > 0 and _finite(entry.values()), name
        stats = entry.get("cache_stats")
        if name.startswith("baseline"):
            assert stats is None
        else:
            assert _finite(stats.values()), name
            assert stats["full_steps"] + stats["mixed_steps"] + stats["cached_steps"] == STEPS_RUN
    assert "sw_vs_baseline" not in results["baseline"]
    csv_text = (tmp_path / "ablation_results/ablation_sweep.csv").read_text()
    assert csv_text == pd.DataFrame(ablation_cache.sweep_rows(written)).to_csv(index=False)


def test_benchmark_cli_runs_every_arm(trained_run, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = benchmark_cache.main([f"model_path={trained_run}", *SAMPLE_ARGS, "+device=cpu"])
    expected = (["baseline", "baseline_self(noise floor)"]
                + [name for name, _ in benchmark_cache.HEADLINE]
                + [name for name, _ in benchmark_cache.sweep_arms(26)])
    assert [row["method"] for row in rows] == expected
    assert "token_b24" in expected and "token_b48" not in expected
    for row in rows:
        assert _finite(row.values()) and row["num_samples"] == 4, row["method"]
        if "cache_full_steps" in row:
            assert (row["cache_full_steps"] + row["cache_mixed_steps"]
                    + row["cache_cached_steps"]) == STEPS_RUN
    assert sum("cache_full_steps" in row for row in rows) == len(rows) - 2
    csv_text = (tmp_path / "outputs/cache_benchmark/benchmark_results.csv").read_text()
    assert csv_text == pd.DataFrame(rows).to_csv(index=False)


# ----------------------------------------------------------------- against the JAX CLIs
class _Clock:
    """A clock that advances half a second at every reading."""

    def __init__(self):
        self.now = 0.0

    def read(self):
        self.now += 0.5
        return self.now


def _fake_stats(kwargs):
    token = (kwargs.get("cache_kwargs") or {}).get("level") == "token"
    return {"cache_hit_ratio": 0.25, "recompute_count": 3, "full_steps": 5,
            "mixed_steps": 2 if token else 0, "cached_steps": 1, "steps_skipped_ratio": 0.125,
            "realized_err_max": 1e-5}


class _FakeSW:
    def __init__(self, original_samples, random_seed, num_directions):
        self.reference = float(np.asarray(original_samples).mean())

    def __call__(self, samples):
        return {"sliced_wasserstein_mean": float(np.asarray(samples).mean()) - self.reference}


def _common_patches(monkeypatch, module, tmp_path, clock):
    monkeypatch.setattr(module, "resolve_model_dir", lambda *a: tmp_path)
    monkeypatch.setattr(module, "get_best_checkpoint", lambda path: path)
    monkeypatch.setattr(module, "load_checkpoint", lambda *a, **k: types.SimpleNamespace(
        max_len=187, network=torch.nn.Linear(1, 1)))
    monkeypatch.setattr(module, "SlicedWasserstein", _FakeSW)
    monkeypatch.setattr(module, "time", types.SimpleNamespace(time=clock.read,
                                                               perf_counter=clock.read))


def test_ablation_cli_is_the_jax_cli(tmp_path, monkeypatch, capsys):
    jax_cli = _jax_cli("ablation_cache")
    assert ablation_cache.ABLATIONS == jax_cli.ABLATIONS
    assert ablation_cache.KV_TAU_SWEEP == jax_cli.KV_TAU_SWEEP
    for tau in (0.5, *jax_cli.KV_TAU_SWEEP):
        assert ablation_cache.kv_event_arm(tau) == jax_cli.kv_event_arm(tau)

    outputs = {}
    for name, module, argv in (("jax", jax_cli, []), ("port", ablation_cache, ["+device=cpu"])):
        made = []

        class FakeSampler:
            def __init__(self, model, sample_batch_size, **kwargs):
                made.append((sample_batch_size, kwargs))
                self.kwargs, self.last_cache_state = kwargs, None

            def sample(self, num_samples, num_steps, **_):
                return np.full((num_samples, 5, 1), len(made) / 7, np.float32)

            def get_cache_stats(self):
                return _fake_stats(self.kwargs)

        run_dir = tmp_path / name
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        _common_patches(monkeypatch, module, run_dir, _Clock())
        monkeypatch.setattr(module, "DiffusionSampler", FakeSampler)
        monkeypatch.setattr("sys.argv", ["ablation_cache", *SAMPLE_ARGS, *argv])
        capsys.readouterr()
        module.main()
        outputs[name] = dict(
            made=made, printed=capsys.readouterr().out,
            json=(run_dir / "ablation_results/ablation_results.json").read_text(),
            csv=(run_dir / "ablation_results/ablation_sweep.csv").read_text())
    assert len(outputs["jax"]["made"]) == len(ablation_cache.arms())
    for key in ("made", "json", "csv", "printed"):
        assert outputs["port"][key] == outputs["jax"][key], key


def test_benchmark_cli_is_the_jax_cli(tmp_path, monkeypatch):
    jax_cli = _jax_cli("benchmark_cache")
    import fdtpu.viz.benchmark_figures as figures

    monkeypatch.setattr(figures, "create_benchmark_figures", lambda *a, **k: [])
    outputs = {}
    for name, module, argv in (("jax", jax_cli, []), ("port", benchmark_cache, ["+device=cpu"])):
        calls = []

        def fake_benchmark(model, num_samples, steps, batch, **kwargs):
            calls.append(((num_samples, steps, batch), kwargs))
            t = 1.0 + 0.25 * len(calls)
            result = {"time_s": t, "samples_per_s": num_samples / t,
                      "num_samples": num_samples, "num_diffusion_steps": steps,
                      "_samples": np.full((num_samples, 5, 1), len(calls) / 3, np.float32)}
            if kwargs.get("use_cache"):
                result.update({f"cache_{k}": v for k, v in _fake_stats(kwargs).items()})
            return result

        run_dir = tmp_path / name
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        _common_patches(monkeypatch, module, run_dir, _Clock())
        monkeypatch.setattr(module, "benchmark_sampling", fake_benchmark)
        monkeypatch.setattr("sys.argv", ["benchmark_cache", *SAMPLE_ARGS, *argv])
        module.main()
        outputs[name] = dict(
            calls=calls,
            csv=(run_dir / "outputs/cache_benchmark/benchmark_results.csv").read_text())
    assert len(outputs["jax"]["calls"]) == 2 + len(benchmark_cache.HEADLINE) + len(
        benchmark_cache.sweep_arms(187))
    for key in ("calls", "csv"):
        assert outputs["port"][key] == outputs["jax"][key], key


# ----------------------------------------------------------------- profiling
def test_block_until_ready_passes_host_results_through(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    result = [torch.zeros(2), {"m": torch.empty(2, device="meta")}, 3]
    assert profiling.block_until_ready(result) is result
    assert synced == []  # nothing on a card: nothing to wait for


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "trace") as prof:
        torch.ones(4).sum()
    assert prof is not None
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert "traceEvents" in trace
