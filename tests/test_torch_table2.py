"""The port's Table-2 harness (``fdtpu_torch.cli.validate_real_data``), the
reference-checkpoint migration (``fdtpu_torch.utils.torch_migration``) and
the MIMIC ``.h5`` writer, against the JAX package.

The harness runs ``all --fixture --smoke --domains frequency --device cpu``
in a temporary working directory: every dataset's JSON passes
``tests/test_table2_schema.py``'s schema, its ``protocol`` and
``reference_table2`` equal the JAX harness's on the same arguments (apart
from the keys the port adds: the device, the training-set size, MIMIC's
fixture form), and nothing under ``docs/benchmarks/`` changes.  The JAX
harness's constants and ``_metric_rows`` are read by loading
``scripts/validate_real_data.py`` with importlib (its JAX settings are put
back after).  The migrated reference checkpoint's forward is held to
``fdtpu.score_apply`` on the JAX loader's variables within 1e-5.
"""

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.models import ScoreModelConfig as JaxConfig
from fdtpu.models import score_apply
from fdtpu.utils.torch_migration import load_reference_checkpoint as jax_load_reference
from fdtpu_torch.cli import validate_real_data as harness
from fdtpu_torch.models.score_models import ScoreModelConfig, init_score_model
from fdtpu_torch.models.score_models import score_apply as port_score_apply
from fdtpu_torch.utils import torch_migration
from test_table2_schema import ALL_DATASETS, assert_table2_schema

REPO = Path(__file__).resolve().parents[1]
PORT_KEYS = {"device", "train_size", "fixture_form"}


def _benchmarks_digest() -> dict[str, str]:
    return {str(p.relative_to(REPO)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO / "docs" / "benchmarks").rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def jax_harness():
    """``scripts/validate_real_data.py`` as a module, its jax.config
    settings undone after loading."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "_jax_validate_real_data", REPO / "scripts" / "validate_real_data.py")
    module = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
        for k, v in saved.items():
            jax.config.update(k, v)
    return module


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The port's harness over the seven fixture trees, on the CPU."""
    work = tmp_path_factory.mktemp("table2")
    before = _benchmarks_digest()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        code = harness.main(["all", "--fixture", "--smoke", "--domains", "frequency",
                             "--device", "cpu", "--data-dir", str(work / "raw"),
                             "--run-dir", str(work / "runs")])
    payloads = {ds: json.loads((work / "outputs/table2_torch" / f"table2_{ds}.json").read_text())
                for ds in ALL_DATASETS}
    return code, payloads, before, _benchmarks_digest(), work


@pytest.mark.parametrize("dataset", ALL_DATASETS)
def test_port_harness_writes_the_table2_schema(sweep, dataset):
    code, payloads, *_ = sweep
    assert code == 0
    payload = payloads[dataset]
    assert_table2_schema(payload, dataset)
    assert payload["protocol"]["device"] == "cpu"
    assert payload["protocol"]["train_size"] > 0
    assert payload["domains"]["frequency"]["arms"]["cached"]["cache_stats"]["current_step"] == 5


def test_port_harness_leaves_docs_benchmarks_alone(sweep):
    _, _, before, after, work = sweep
    assert after == before
    assert sorted(p.name for p in (work / "outputs/table2_torch").iterdir()) == sorted(
        f"table2_{ds}.json" for ds in ALL_DATASETS)


@pytest.mark.parametrize("dataset", ALL_DATASETS)
def test_protocol_and_reference_are_the_jax_harness(sweep, jax_harness, tmp_path, monkeypatch,
                                                    dataset):
    _, payloads, *_ = sweep
    monkeypatch.setattr(jax_harness, "_load_cli", lambda name: None)
    out = tmp_path / "jax.json"
    jax_harness.run_dataset(argparse.Namespace(
        dataset=dataset, data_dir=tmp_path / "raw", run_dir=tmp_path / "runs", out=out,
        epochs=40, num_samples=1000, steps=1000, sample_batch=128, seed=42, domains=[],
        fixture=True, override=[], smoke=True))
    want = json.loads(out.read_text())
    got = payloads[dataset]
    assert {k: v for k, v in got["protocol"].items() if k not in PORT_KEYS} == want["protocol"]
    assert got["reference_table2"] == want["reference_table2"]
    assert got.get("warning") == want.get("warning")
    assert (got["protocol"].get("fixture_form") == "h5") == (dataset == "mimic")


def test_constants_and_metric_rows_are_the_jax_harness(jax_harness, sweep):
    assert harness.REFERENCE_TABLE2 == jax_harness.REFERENCE_TABLE2
    assert harness.CACHED_KWARGS == jax_harness.CACHED_KWARGS
    assert harness.DATASETS == jax_harness.DATASETS
    *_, work = sweep
    from fdtpu_torch.utils import yaml_subset

    results = yaml_subset.load(work / "runs/table2_ecg_frequency/results.yaml")
    assert "time_sliced_wasserstein_all" in results
    assert harness._metric_rows(results) == jax_harness._metric_rows(results)
    partial = {"time_sliced_wasserstein_mean": 1.5, "freq_marginal_wasserstein_all": [1.0, 2.0],
               "spectral_sliced_wasserstein_mean_self": 0.25}
    assert harness._metric_rows(partial) == jax_harness._metric_rows(partial)


def test_harness_defaults_to_the_card_and_its_own_directory():
    args = harness.parse_args(["ecg"])
    assert args.device == "cuda" and args.data_dir == Path("data")
    assert harness.OUT_DIR == Path("outputs/table2_torch")


# ------------------------------------------------------------ migration
@pytest.fixture(scope="module")
def reference_ckpt(tmp_path_factory):
    """A reference-style Lightning ``.ckpt`` (the torch reference pipeline's
    weights and a pickled scheduler object), as tests/test_torch_parity.py
    builds it."""
    from test_torch_parity import CHANNELS, D, FF, H, L, MAX_LEN, FakeScheduler, TorchRefModel

    torch.manual_seed(0)
    ref = TorchRefModel().eval()
    ckpt = {"state_dict": ref.fdtpu_state_dict(),
            "hyper_parameters": {"noise_scheduler": FakeScheduler(), "d_model": D}, "epoch": 3}
    path = tmp_path_factory.mktemp("ckpt") / "epoch=3-val_loss=0.01.ckpt"
    torch.save(ckpt, path)
    shape = dict(n_channels=CHANNELS, max_len=MAX_LEN, d_model=D, num_layers=L, n_head=H,
                 dim_feedforward=FF)
    return path, shape, FakeScheduler


def _forwards(path, shape):
    jcfg = JaxConfig(**shape)
    variables = jax_load_reference(path, jcfg)
    cfg = ScoreModelConfig(**shape)
    net = init_score_model(cfg, device="cpu")
    net.load_state_dict(torch_migration.load_reference_checkpoint(path, cfg), strict=True)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, shape["max_len"], shape["n_channels"])).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, 5).astype(np.float32)
    want = np.asarray(score_apply(jax.tree.map(jnp.asarray, variables), jcfg,
                                  jnp.asarray(x), jnp.asarray(t)))
    got = port_score_apply(net, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    return got, want


def test_reference_checkpoint_forward_is_the_jax_loaders(reference_ckpt):
    path, shape, _ = reference_ckpt
    got, want = _forwards(path, shape)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_reference_checkpoint_with_an_unimportable_class(reference_ckpt):
    path, shape, cls = reference_ckpt
    module = sys.modules[cls.__module__]
    delattr(module, cls.__name__)
    try:
        with pytest.raises(AttributeError):
            torch.load(path, map_location="cpu", weights_only=False)
        got, want = _forwards(path, shape)
    finally:
        setattr(module, cls.__name__, cls)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_migration_is_for_the_transformer_only(reference_ckpt):
    path, shape, _ = reference_ckpt
    with pytest.raises(ValueError, match="transformer"):
        torch_migration.load_reference_checkpoint(
            path, ScoreModelConfig(**shape, backbone="mlp"))


# ------------------------------------------------------- MIMIC .h5 writer
@pytest.mark.parametrize("n_features,n_subjects", [(5, 3), (104, 10)])
def test_mimic_h5_writer_reads_as_the_jax_writers_file(tmp_path, n_features, n_subjects):
    pytest.importorskip("h5py")
    import fdtpu.data as jdata
    import fdtpu_torch.data as pdata
    from fdtpu.data import fixtures as jfix
    from fdtpu.data.hdf_fixed import read_fixed_frame as jax_read
    from fdtpu_torch.data import fixtures as pfix
    from fdtpu_torch.data.hdf_fixed import read_fixed_frame as port_read

    jfix.write_mimic_fixture(tmp_path / "jax", n_features=n_features, n_subjects=n_subjects)
    pfix.write_mimic_fixture(tmp_path / "port", n_features=n_features, n_subjects=n_subjects)
    files = {k: tmp_path / k / "mimiciii/all_hourly_data.h5" for k in ("jax", "port")}
    import pandas as pd

    for key in ("patients", "vitals_labs"):
        pd.testing.assert_frame_equal(jax_read(files["port"], key), jax_read(files["jax"], key))
        got, want = port_read(files["port"], key), port_read(files["jax"], key)
        assert got.columns == want.columns and got.column_names == want.column_names
        assert list(got.index) == list(want.index)
        for a, b in zip([*got.index.values(), *got.data], [*want.index.values(), *want.data]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if n_subjects < 10:
        return
    for package in (jdata, pdata):
        arrays = []
        for root in ("jax", "port"):
            dm = package.MIMICIIIDatamodule(data_dir=tmp_path / root, batch_size=2)
            dm.prepare_data()
            dm.setup("fit")
            arrays.append((dm.X_train, dm.X_test))
            for f in ("X_train.npy", "X_test.npy"):
                (tmp_path / root / "mimiciii" / f).unlink()
        for a, b in zip(*arrays):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_viz_tables_on_the_harness_runs_are_the_jax_tables(sweep, tmp_path):
    """The tables chip_smoke.py writes on the card, from the port's own run
    directories (``results.yaml`` written by the port's YAML writer), equal
    the JAX viz tables on the same directories byte for byte."""
    import fdtpu.viz as jviz
    import fdtpu_torch.viz as pviz

    *_, work = sweep
    runs = work / "runs"
    run_ids = [f"table2_{ds}_frequency" for ds in ALL_DATASETS]
    jm, _ = jviz.process_run_metrics(run_ids, runs, tmp_path / "jax")
    pm, _ = pviz.process_run_metrics(run_ids, runs, tmp_path / "port")
    for metric in ("Sliced Wasserstein", "Marginal Wasserstein"):
        jviz.create_summary_table(jm, metric, tmp_path / "jax")
        pviz.create_summary_table(pm, metric, tmp_path / "port")
    jviz.process_spectral_analysis(run_ids, runs, tmp_path / "jax")
    pviz.process_spectral_analysis(run_ids, runs, tmp_path / "port")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 3 + 4
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert pviz.results_to_latex(pviz.process_results(runs)) == \
        jviz.results_to_latex(jviz.process_results(runs))
