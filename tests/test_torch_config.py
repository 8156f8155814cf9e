"""Port parity: config reading and composition, and the builders,
fdtpu_torch against fdtpu (and PyYAML) on the CPU.

The port reads YAML with its own reader (the card's machine has no PyYAML):
it must equal ``yaml.safe_load`` exactly, on every file under ``configs/``
and on the scalar spellings whose YAML 1.1 resolution is easy to get wrong.
Composition, the config round trip across the two packages and the
builders' model configs are compared exactly; the metrics at rtol 1e-6
(the same numpy arithmetic on data that went through two DFTs).
"""

import datetime
import math
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from fdtpu.utils import builders as jax_builders
from fdtpu.utils import config as jax_config
from fdtpu.models.score_models import ScoreModelConfig as JaxScoreModelConfig
from fdtpu_torch.utils import builders, config, yaml_subset, wandb

REPO = Path(__file__).resolve().parents[1]
CONFIG_DIR = REPO / "configs"
CONFIG_FILES = sorted(CONFIG_DIR.rglob("*.yaml"))


def _same(a, b) -> bool:
    """Equal values of equal types, NaN equal to NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_config_dir_is_the_repositorys():
    assert config.CONFIG_DIR == CONFIG_DIR and len(CONFIG_FILES) >= 15


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: str(p.relative_to(CONFIG_DIR)))
def test_reader_equals_safe_load_on_every_config(path):
    want = yaml.safe_load(path.read_text())
    assert _same(yaml_subset.load(path), want)


SCALARS = [
    "1e-3", "1.0e-3", "1.0e-5", "1.0e+16", "1E-3", "1.", ".5", "-.5", "+1", "-0", "1_000",
    "20260816_201855", "017", "08", "0x1F", "0b101", "1:30", "190:20:30.15", "0o17",
    "on", "off", "On", "OFF", "yes", "No", "y", "n", "true", "False", "TRUE", "tRue",
    "null", "Null", "NULL", "~", "", "nul", ".inf", "-.Inf", "+.INF", ".nan", ".NaN",
    "2020-01-01", "2020-1-1", "2001-12-14t21:59:43.10-05:00", "2001-12-14 21:59:43.10",
    "'quoted'", "'it''s'", '"tab\\there"', '"\\u00e9\\U0001F600"', '"1.0"', "'yes'",
    "a b", "x#y", "x #comment", "http://host/path", "-x", "lightning_logs", "${a.b}",
    "[]", "{}", "[1, 2.0, x]", "[1.0,0.5]", "{a: 1, b: [x, 'y']}", "{a:1}", "{a: }",
    "a: b", "- a\n- b", "k: [1, {m: n}]",
]


@pytest.mark.parametrize("text", SCALARS)
def test_reader_resolves_scalars_as_safe_load(text):
    want = yaml.safe_load(text)
    assert _same(yaml_subset.loads(text), want), (yaml_subset.loads(text), want)


def test_reader_dates_are_dates():
    assert yaml_subset.loads("2020-01-01") == datetime.date(2020, 1, 1)


@pytest.mark.parametrize("text", ["&a 1", "*a", "!!str 1", "a: |\n  x", "a: >\n  x", "---\na: 1",
                                  "'open", "a: 1\n  b: 2", "\ta: 1"])
def test_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(yaml_subset.YAMLSubsetError):
        yaml_subset.loads(text)


VALUES = {
    "run_id": "20260816_201855", "flag": "yes", "empty": "", "eps": 1e-5, "big": 1e16,
    "neg": -0.0, "inf": float("inf"), "none": None, "bools": [True, False], "ints": [1, -2],
    "nested": {"list_of_maps": [{"a": 1, "b": [1.5, "x y"]}, [1, [2]]], "empty_map": {},
               "empty_list": []},
    "odd": "a: b # c", "unicode": "é\U0001F600\n", "dash": "-", "hash": "#x", 7: "int key",
}


def test_dumps_round_trips_through_both_readers():
    text = yaml_subset.dumps(VALUES)
    assert _same(yaml.safe_load(text), VALUES)
    assert _same(yaml_subset.loads(text), VALUES)
    assert _same(yaml_subset.loads(yaml.safe_dump(VALUES, sort_keys=False)), VALUES)


def test_dumps_refuses_other_types():
    with pytest.raises(TypeError):
        yaml_subset.dumps({"a": object()})


OVERRIDES = [
    ("train", []),
    ("sample", []),
    ("train", ["datamodule=synthetic", "fourier_transform=true", "score_model=lstm",
               "trainer.max_epochs=7", "score_model.noise_scheduler=vesde"]),
    ("sample", ["+cache_kwargs.K=5", "use_cache=true"]),
    ("sample", ["metrics.metrics.0.num_directions=17"]),
    ("sample", ["model_id=20260816_201855"]),
    ("train", ["score_model=mlp", "score_model.noise_scheduler=vesde"]),
    ("train", ["datamodule=synthetic", "datamodule.data_dir=/tmp/x", "datamodule.max_len=20",
               "datamodule.num_samples=128", "trainer.max_epochs=2", "score_model.d_model=8",
               "score_model.num_layers=1", "score_model.n_head=2",
               "score_model.dim_feedforward=16", "run_dir=/tmp/runs"]),
    ("sample", ["model_path=/tmp/runs", "model_id=latest", "num_samples=8",
                "num_diffusion_steps=4", "sampler.sample_batch_size=8",
                "metrics.metrics.0.num_directions=10", "use_cache=true",
                "+cache_kwargs.level=score", "+cache_kwargs.R=2"]),
    ("sample", ["+sampler.use_cache=true", "+sampler.cache_kwargs.level=score"]),
    ("sample", ["use_cache=true", "+calibrate_tau=true", "+calibrate_kwargs.ladder=[1.0,0.5]",
                "+calibrate_kwargs.num_directions=16"]),
    ("train_with_cache_benchmark", ["trainer=diffusion_comparison", "+device=cpu",
                                    "cache_benchmark.cache_kwargs={level: score, R: 5}"]),
]


@pytest.mark.parametrize("name, overrides", OVERRIDES)
def test_compose_config_equals_jax(name, overrides):
    want = jax_config.compose_config(CONFIG_DIR, name, overrides)
    assert _same(config.compose_config(CONFIG_DIR, name, overrides), want)


def test_compose_config_refuses_unknown_keys():
    with pytest.raises(KeyError):
        config.compose_config(CONFIG_DIR, "sample", ["nonexistent.key=1"])


def test_split_config_name():
    assert config.split_config_name(["a=1", "--config-name", "x", "b=2"], "train") == (
        "x", ["a=1", "b=2"])
    assert config.split_config_name(["--config-name=y"], "train") == ("y", [])
    assert config.split_config_name(["a=1"], "train") == ("train", ["a=1"])


def test_flatten_and_str_equal_jax():
    cfg = config.compose_config(CONFIG_DIR, "train", [])
    assert config.flatten_config(cfg) == jax_config.flatten_config(cfg)
    assert config.dict_to_str(config.flatten_config(cfg)) == jax_config.dict_to_str(
        jax_config.flatten_config(cfg))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_config_round_trips_across_packages(tmp_path, writer):
    cfg = config.compose_config(CONFIG_DIR, "train", ["datamodule=synthetic",
                                                      "+run_id=20260816_201855"])
    cfg["odd"] = {"s": "yes", "t": "1e-3", "u": 1e-3, "v": [], "w": None}
    path = tmp_path / "train_config.yaml"
    (jax_config if writer == "jax" else config).save_config(cfg, path)
    assert _same(config.load_config(path), cfg)
    assert _same(jax_config.load_config(path), cfg)


@pytest.mark.parametrize("score_model", ["default", "mlp", "lstm"])
@pytest.mark.parametrize("scheduler", ["vpsde", "vesde"])
def test_build_model_config_equals_jax(score_model, scheduler):
    cfg = config.compose_config(CONFIG_DIR, "train", [
        f"score_model={score_model}", f"score_model.noise_scheduler={scheduler}",
        "score_model.num_layers=1", "score_model.dim_feedforward=16", "+score_model.d_mlp=16",
        "+device=cpu"])
    params = {"n_channels": 2, "max_len": 12, "num_training_steps": 30}
    model = builders.build_model(cfg, params, device="cpu")
    jmodel = jax_builders.build_model(cfg, params)
    want = jmodel.config
    assert isinstance(want, JaxScoreModelConfig)
    for field in want.__dataclass_fields__:
        got = getattr(model.config, field)
        assert got == getattr(want, field) and type(got) is type(getattr(want, field)), field
    assert (model.num_training_steps, model.lr_max, model.likelihood_weighting) == (
        jmodel.num_training_steps, jmodel.lr_max, jmodel.likelihood_weighting)
    assert model.param_count() == jmodel.param_count()
    js, ps = jmodel.scheduler, model.scheduler
    assert type(ps).__name__ == type(js).__name__
    for k in ("eps", "fourier_noise_scaling", "beta_min", "beta_max", "sigma_min", "sigma_max"):
        assert getattr(ps, k, None) == getattr(js, k, None), k
    np.testing.assert_array_equal(ps.G.numpy(), np.asarray(js.G))


def test_build_model_draws_from_the_seed():
    cfg = config.compose_config(CONFIG_DIR, "train", ["score_model.num_layers=1"])
    params = {"n_channels": 1, "max_len": 8, "num_training_steps": 10}
    a = builders.build_model(cfg, params, device="cpu").network.state_dict()
    b = builders.build_model(cfg, params, generator=torch.Generator().manual_seed(42),
                             device="cpu").network.state_dict()
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_build_metrics_equals_jax():
    cfg = config.compose_config(CONFIG_DIR, "sample", ["metrics.metrics.0.num_directions=7"])
    rng = np.random.default_rng(0)
    train = rng.standard_normal((20, 10, 2)).astype(np.float32)
    samples = rng.standard_normal((10, 10, 2)).astype(np.float32)
    got = builders.build_metrics(cfg, original_samples=train)(samples)
    want = jax_builders.build_metrics(cfg, original_samples=train)(samples)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_build_datamodule_synthetic(tmp_path):
    def cfg(data_dir):
        return config.compose_config(CONFIG_DIR, "train", [
            "datamodule=synthetic", f"datamodule.data_dir={data_dir}", "datamodule.max_len=16",
            "datamodule.num_samples=20"])

    dm = builders.build_datamodule(cfg(tmp_path / "port"))
    jdm = jax_builders.build_datamodule(cfg(tmp_path / "jax"))
    for d in (dm, jdm):
        d.prepare_data()
        d.setup("fit")
    np.testing.assert_array_equal(dm.X_train, jdm.X_train)
    assert dm.dataset_parameters == jdm.dataset_parameters


@pytest.mark.parametrize("name", ["ecg", "mimiciii", "nasdaq", "nasa", "usdroughts"])
def test_build_datamodule_names_the_roadmap_for_the_others(name, tmp_path, monkeypatch):
    """The real datamodules build as the JAX builder's, and with no data
    they stop with the JAX package's informative error (no download: the
    kaggle import is made to fail)."""
    monkeypatch.setitem(sys.modules, "kaggle", None)
    cfg = config.compose_config(CONFIG_DIR, "train", [f"datamodule={name}",
                                                      f"datamodule.data_dir={tmp_path}"])
    dm, jdm = builders.build_datamodule(cfg), jax_builders.build_datamodule(cfg)
    assert type(dm).__name__ == type(jdm).__name__
    assert dm.data_dir == jdm.data_dir and dm.batch_size == jdm.batch_size
    errors = []
    for d in (jdm, dm):
        shutil.rmtree(tmp_path, ignore_errors=True)
        with pytest.raises((RuntimeError, AssertionError)) as info:
            d.prepare_data()
        errors.append((info.type, str(info.value)))
    assert errors[0] == errors[1]
    assert "kaggle" in errors[0][1] or "MIMIC" in errors[0][1]


def test_resolve_model_dir_equals_jax(tmp_path):
    import os

    for name in ("a", "b", "no_config"):
        run = tmp_path / name
        run.mkdir()
        if name != "no_config":
            (run / "train_config.yaml").write_text("x: 1\n")
    os.utime(tmp_path / "a", (2e9, 2e9))
    for model_id in ("latest", "b"):
        assert builders.resolve_model_dir(tmp_path, model_id) == jax_builders.resolve_model_dir(
            tmp_path, model_id)
    for bad in ("no_config", "missing"):
        with pytest.raises(FileNotFoundError, match="Available"):
            builders.resolve_model_dir(tmp_path, bad)


def test_wandb_stays_off_and_warns_when_missing(monkeypatch, caplog):
    import sys

    assert wandb.maybe_initialize_wandb({"use_wandb": False}) is None
    monkeypatch.setitem(sys.modules, "wandb", None)  # an import of it fails
    with caplog.at_level("WARNING"):
        assert wandb.maybe_initialize_wandb({"use_wandb": True}) is None
    assert "not installed" in caplog.text
    monkeypatch.delitem(sys.modules, "wandb")
    wandb.maybe_log_wandb({"a": 1})
    wandb.maybe_log_model(".")
    assert "wandb" not in sys.modules
