"""The port's CLIs, ``fdtpu_torch.cli.train`` and ``fdtpu_torch.cli.sample``,
in-process on the CPU (``+device=cpu``) at tiny widths, held to the JAX
CLIs' artifacts: the same file names, ``meta.json`` and ``results.yaml``
keys, and the JAX package's metrics on the samples the port wrote (the
time-domain ones at rtol 1e-12, the same numpy arithmetic; the frequency and
spectral ones at rtol 1e-5, atol 1e-7, through each package's own DFT, as
tests/test_torch_metrics.py holds them).  One subprocess runs
``python -m fdtpu_torch.cli.train`` and shows that it imports no JAX.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from fdtpu.diffusion import VPScheduler as JaxVP
from fdtpu.models.score_models import ScoreModelConfig as JaxScoreModelConfig
from fdtpu.train.checkpoint import scheduler_to_meta as jax_scheduler_to_meta
from fdtpu.utils import builders as jax_builders
from fdtpu.utils.config import compose_config as jax_compose_config
from fdtpu_torch.cli import sample as sample_cli
from fdtpu_torch.cli import train as train_cli

REPO = Path(__file__).resolve().parents[1]
TINY_MODEL = ["score_model.d_model=8", "score_model.num_layers=1", "score_model.n_head=2",
              "score_model.dim_feedforward=16"]
# The keys the JAX package writes (fdtpu/train/checkpoint.py:72-80, 140-147).
CHECKPOINT_META = {"epoch", "val_loss", "model_config", "scheduler", "num_training_steps",
                   "lr_max", "likelihood_weighting"}
RESUME_META = {"epoch", "global_step", "best_val_loss"}


def _train_args(tmp, *extra):
    return ["datamodule=synthetic", f"datamodule.data_dir={tmp / 'data'}",
            "datamodule.max_len=20", "datamodule.num_samples=64", "fourier_transform=true",
            "trainer.max_epochs=2", *TINY_MODEL, f"run_dir={tmp / 'runs'}", "+device=cpu",
            *extra]


def _sample(run_dir, *extra):
    return sample_cli.main([f"model_path={run_dir.parent}", f"model_id={run_dir.name}",
                            "num_samples=8", "num_diffusion_steps=4",
                            "sampler.sample_batch_size=4", "metrics.metrics.0.num_directions=10",
                            "+device=cpu", *extra])


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    runner = train_cli.main(_train_args(tmp_path_factory.mktemp("cli")))
    return runner.trainer.run_dir


def test_train_cli_writes_the_jax_clis_artifacts(trained_run):
    assert (trained_run / "metrics.jsonl").exists()
    config = yaml.safe_load((trained_run / "train_config.yaml").read_text())
    assert config["datamodule"]["name"] == "synthetic" and config["device"] == "cpu"
    ckpt = max((trained_run / "checkpoints").glob("epoch=*-val_loss=*.ckpt"))
    meta = json.loads((ckpt / "meta.json").read_text())
    assert set(meta) == CHECKPOINT_META
    assert set(meta["model_config"]) == set(JaxScoreModelConfig.__dataclass_fields__)
    assert meta["model_config"]["d_model"] == 8 and meta["model_config"]["max_len"] == 20
    assert set(meta["scheduler"]) == set(jax_scheduler_to_meta(JaxVP()))
    assert set(json.loads((trained_run / "resume" / "meta.json").read_text())) == RESUME_META
    records = [json.loads(line) for line in (trained_run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records if "val/loss" in r] == [0, 1]


def test_sample_cli_uncached_scores_like_the_jax_metrics(trained_run):
    runner = _sample(trained_run)
    samples = np.load(trained_run / "samples.npy")
    assert samples.shape == (8, 20, 1) and np.isfinite(samples).all()
    results = yaml.safe_load((trained_run / "results.yaml").read_text())
    cfg = jax_compose_config(REPO / "configs", "sample", ["metrics.metrics.0.num_directions=10"])
    want = jax_builders.build_metrics(cfg, original_samples=runner.datamodule.X_train)(samples)
    assert list(results) == list(want)
    for k in want:
        tol = dict(rtol=1e-12) if k.startswith("time_") else dict(rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(results[k], want[k], err_msg=k, **tol)
    sample_config = yaml.safe_load((trained_run / "sample_config.yaml").read_text())
    assert sample_config["num_samples"] == 8 and not runner.sampler.use_cache


@pytest.mark.parametrize("cache", [
    ["use_cache=true", "+cache_kwargs.level=score", "+cache_kwargs.R=2"],
    ["+sampler.use_cache=true", "+sampler.cache_kwargs.level=score"],
    ["use_cache=true", "+cache_kwargs.level=token", "+cache_kwargs.token_budget=4",
     "+cache_kwargs.tau_0=0.5", "+cache_kwargs.R=2"],
    ["use_cache=true", "+cache_kwargs.level=kv", "+cache_kwargs.policy=macro",
     "+cache_kwargs.K=1", "+cache_kwargs.R=2"],
], ids=["score", "sampler-level-flags", "token", "kv-macro"])
def test_sample_cli_cached(trained_run, cache):
    runner = _sample(trained_run, *cache)
    assert runner.sampler.use_cache
    stats = yaml.safe_load((trained_run / "cache_stats.yaml").read_text())
    # Two batches of four steps: the step counter runs across batches.
    assert stats["current_step"] == 8 and stats == runner.sampler.get_cache_stats()
    np.testing.assert_array_equal(np.load(trained_run / "samples_cache" / "samples.npy"),
                                  np.load(trained_run / "samples.npy"))


def test_sample_cli_calibrated_tau(trained_run):
    runner = _sample(trained_run, "use_cache=true", "+calibrate_tau=true",
                     "+calibrate_kwargs.ladder=[1.0,0.5]", "+calibrate_kwargs.num_directions=16")
    cal = yaml.safe_load((trained_run / "calibration.yaml").read_text())
    assert set(cal) == {"tau_0", "sw_noise_floor", "arms"} and cal["sw_noise_floor"] > 0
    assert [a["tau_0"] for a in cal["arms"]] == [1.0, 0.5][:len(cal["arms"])]
    for arm in cal["arms"]:
        assert set(arm) >= {"tau_0", "sw_vs_uncached", "within_floor", "guard_silent"}
    assert runner.sampler.use_cache == (cal["tau_0"] is not None)


@pytest.mark.parametrize("backbone", ["mlp", "lstm"])
def test_cli_trains_and_samples_the_mlp_and_lstm_backbones(tmp_path, backbone):
    runner = train_cli.main(_train_args(tmp_path, f"score_model={backbone}",
                                        "trainer.max_epochs=1", "+score_model.d_mlp=16"))
    assert runner.model.config.backbone == backbone
    sampled = _sample(runner.trainer.run_dir, "use_cache=true", "+cache_kwargs.level=score")
    assert sampled.model.config.backbone == backbone
    assert np.isfinite(np.load(runner.trainer.run_dir / "samples.npy")).all()


def test_train_cli_config_name_cache_benchmark_and_callbacks(tmp_path):
    runner = train_cli.main(["--config-name", "train_with_cache_benchmark",
                             *_train_args(tmp_path, "trainer=diffusion_comparison",
                                          "trainer.max_epochs=1",
                                          "trainer.diffusion_comparison.num_samples=2",
                                          "+trainer.sampling_callback.enabled=true",
                                          "+trainer.sampling_callback.every_n_epochs=1",
                                          "+trainer.sampling_callback.num_samples=4",
                                          "+trainer.sampling_callback.num_diffusion_steps=3",
                                          "+trainer.sampling_callback.sample_batch_size=4",
                                          "+trainer.sampling_callback.num_directions=5")])
    bench = json.loads((runner.trainer.run_dir / "cache_benchmark.json").read_text())
    assert set(bench) == {"uncached", "cached", "speedup"}
    assert bench["cached"]["cache_stats"]["current_step"] == 5
    records = [json.loads(line) for line in runner.trainer.metrics_path.read_text().splitlines()]
    assert any("diffusion_comparison" in r for r in records)
    assert any("metrics/sliced_wasserstein_mean" in r for r in records)


def test_cli_runs_on_cuda_unless_told_otherwise(tmp_path, trained_run):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match=r"\+device=cpu"):
        train_cli.main([a for a in _train_args(tmp_path) if a != "+device=cpu"])
    assert not list((tmp_path / "runs").glob("*/checkpoints"))
    with pytest.raises(RuntimeError, match=r"\+device=cpu"):
        sample_cli.main([f"model_path={trained_run.parent}", f"model_id={trained_run.name}"])


def test_train_module_runs_without_jax(tmp_path):
    """``python -m fdtpu_torch.cli.train`` with ``-X importtime``: it runs,
    and no module of JAX, the JAX package, PyYAML, orbax, optax or pandas is
    imported."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "fdtpu_torch.cli.train",
         *_train_args(tmp_path, "trainer.max_epochs=1")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    imported = {line.rsplit("|", 1)[1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:") and "|" in line}
    assert {"fdtpu_torch.cli", "fdtpu_torch.train.trainer"} <= imported
    forbidden = {"jax", "jaxlib", "flax", "fdtpu", "yaml", "orbax", "optax", "pandas"}
    assert not {m for m in imported if m.split(".")[0] in forbidden}
    assert list((tmp_path / "runs").glob("*/checkpoints/*.ckpt"))
