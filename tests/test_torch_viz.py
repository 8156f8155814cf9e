"""Port parity of the viz tables and figures: ``fdtpu_torch.viz`` (row dicts,
no pandas) against ``fdtpu.viz`` (pandas) on the same run directories.

The run directories are made from a seed with numpy: ``results.yaml``
written with ``yaml.safe_dump``, as the JAX sample CLI writes it,
``train_config.yaml`` and ``samples.npy``.  The rows equal the JAX frames'
records; the summary tables' CSV and ``.tex`` and ``results_to_latex`` are
equal byte for byte; the spectral profiles within 1e-12 (float64 on both
sides); ``process_dataset``'s tables on the ECG fixture within 1e-6
relative (two float32 FFTs); a figure by the data on its axes (lines, bars,
boxes, scatter offsets, images, table cells) against the JAX figure's, at
rtol 1e-6 (1e-5 where the data comes from the two FFTs).
"""

import math
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import yaml

import fdtpu.viz as jviz
import fdtpu_torch.viz as pviz
from fdtpu.viz import benchmark_figures as jbf
from fdtpu.viz import results as jres
from fdtpu_torch.utils import tables
from fdtpu_torch.viz import benchmark_figures as pbf
from fdtpu_torch.viz import spectral_interpretation as pspec

# Runs: (run id, datamodule config, fourier_transform, distances a list).
# The datasets are listed out of order, one has a single run in one domain
# (its sem is NaN), one is in the frequency domain only.
RUNS = [
    ("r0", {"name": "nasdaq"}, True, 12),
    ("r1", {"name": "nasdaq"}, False, 12),
    ("r2", {"name": "ecg"}, True, 1),
    ("r3", {"name": "ecg"}, True, 9),
    ("r4", {"name": "ecg"}, False, 1),
    ("r5", {"name": "nasa", "subdataset": "discharge"}, True, 7),
    ("r6", {"name": "nasa", "subdataset": "charge"}, False, 5),
    ("r7", {"name": "nasdaq"}, True, 3),
]
MAX_LEN, CHANNELS = 16, 2


def _write_run(runs_dir: Path, run_id, datamodule, fourier, n, seed):
    rng = np.random.default_rng(seed)
    run = runs_dir / run_id
    run.mkdir(parents=True)
    config = {"datamodule": dict(datamodule), "fourier_transform": fourier,
              "score_model": {"backbone": "transformer" if seed % 3 else "lstm",
                              "noise_scheduler": {"class": "VPScheduler"}}}
    (run / "train_config.yaml").write_text(yaml.safe_dump(config))
    results = {}
    for domain in ("time", "freq"):
        results[f"{domain}_sliced_wasserstein_all"] = rng.uniform(0.1, 3.0, n).tolist()
        results[f"{domain}_marginal_wasserstein_all"] = rng.uniform(0.1, 3.0, n).tolist()
        for method in ("sliced", "marginal"):
            vals = results[f"{domain}_{method}_wasserstein_all"]
            results[f"{domain}_{method}_wasserstein_mean"] = float(np.mean(vals))
            results[f"{domain}_{method}_wasserstein_mean_self"] = float(rng.uniform(0, 1))
            results[f"{domain}_{method}_wasserstein_mean_dummy"] = float(rng.uniform(1, 2))
    results["spectral_marginal_wasserstein_all"] = rng.uniform(
        1e-3, 1.0, (MAX_LEN // 2 + 1) * CHANNELS).tolist()
    (run / "results.yaml").write_text(yaml.safe_dump(results))
    np.save(run / "samples.npy", rng.normal(size=(6, MAX_LEN, CHANNELS)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    runs_dir = tmp_path_factory.mktemp("runs")
    for seed, (run_id, dm, fourier, n) in enumerate(RUNS):
        _write_run(runs_dir, run_id, dm, fourier, n, seed)
    (runs_dir / "no_results").mkdir()
    return runs_dir, [r[0] for r in RUNS] + ["missing"]


def _records(df: pd.DataFrame) -> list[dict]:
    """A frame's records without its missing cells."""
    return [{k: v for k, v in r.items() if not (isinstance(v, float) and math.isnan(v))}
            for r in df.to_dict("records")]


# ------------------------------------------------------------------ tables
def test_float_text_is_astype_str():
    values = [1e-05, np.nan, 0.07, 1e16, 123456789012.0, -0.0, np.inf, 0.1 + 0.2, 2.675]
    want = pd.Series(values).astype(str).tolist()
    got = [tables.float_text(v) for v in values]
    assert got == [None if isinstance(w, float) else w for w in want]


def test_round_3_on_halves_is_pandas_round():
    values = np.array([0.0005, 0.0015, 0.0025, 2.675, 1.0005, -0.0005, 0.1235])
    np.testing.assert_array_equal(np.round(values, 3), pd.Series(values).round(3).to_numpy())


@pytest.mark.parametrize("config", [
    {"datamodule": {"name": "ecg"}, "fourier_transform": True},
    {"datamodule": {"name": "NASA"}},
    {"datamodule": {"name": "nasa", "subdataset": "discharge"}},
    {"datamodule": {"name": "mimiciii"}, "fourier_transform": False},
    {"datamodule": None},
    {},
])
def test_infer_dataset_and_domain(config):
    assert pviz.infer_dataset(config) == jviz.infer_dataset(config)
    assert pviz.infer_diffusion_domain(config) == jviz.infer_diffusion_domain(config)


def test_metric_and_baseline_rows_equal(runs):
    runs_dir, _ = runs
    for run_id, *_ in RUNS:
        results = yaml.safe_load((runs_dir / run_id / "results.yaml").read_text())
        assert pviz.calculate_metrics(results) == jviz.calculate_metrics(results)
        assert pviz.calculate_baselines(results) == jviz.calculate_baselines(results)


def test_process_results_rows_and_tables(runs, tmp_path):
    runs_dir, _ = runs
    assert pviz.process_results(runs_dir) == _records(jviz.process_results(runs_dir))
    rows = pviz.process_results(runs_dir)
    assert pviz.results_to_latex(rows) == jviz.results_to_latex(jviz.process_results(runs_dir))


def test_process_run_metrics_rows_and_csvs(runs, tmp_path):
    runs_dir, run_ids = runs
    jm, jb = jviz.process_run_metrics(run_ids, runs_dir, tmp_path / "jax")
    pm, pb = pviz.process_run_metrics(run_ids, runs_dir, tmp_path / "port")
    assert pm == jm.to_dict("records")
    assert pb == jb.to_dict("records")
    for name in ("metrics.csv", "baselines.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    with pytest.raises(ValueError, match="No valid runs"):
        pviz.process_run_metrics(["missing"], runs_dir)


@pytest.mark.parametrize("metric", ["Sliced Wasserstein", "Marginal Wasserstein"])
def test_create_summary_table_bytes(runs, tmp_path, metric):
    runs_dir, run_ids = runs
    jm, _ = jviz.process_run_metrics(run_ids, runs_dir)
    pm, _ = pviz.process_run_metrics(run_ids, runs_dir)
    want = jviz.create_summary_table(jm, metric, tmp_path / "jax")
    got = pviz.create_summary_table(pm, metric, tmp_path / "port")
    assert got.rows == want.index.tolist()
    assert got.columns == want.columns.tolist()
    assert got.index_names == list(want.index.names)
    np.testing.assert_array_equal(got.values, want.to_numpy())
    stem = metric.lower().replace(" ", "_")
    for name in (f"{stem}_summary.csv", f"{stem}.tex"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_summary_table_traps(tmp_path):
    """Unsorted keys, a single value (sem NaN, its cell missing), a column
    missing for a dataset, means that round on halves."""
    rows = []
    for dataset, mdomain, ddomain, values in (
        ("Zeta", "Time", "Time", [0.0015]),
        ("Zeta", "Time", "Frequency", [0.0005, 0.0005]),
        ("Alpha", "Frequency", "Time", [2.675, 2.675, 2.675]),
        ("Alpha", "Time", "Time", [1e-05, 3e-05]),
        ("Mid", "Time", "Frequency", [1.0005, 1.0015, 0.9995]),
        ("Alpha", "Frequency", "Time", [np.nan]),
    ):
        rows += [{"Value": v, "Metric Domain": mdomain, "Metric": "Sliced Wasserstein",
                  "Dataset": dataset, "Diffusion Domain": ddomain} for v in values]
    want = jviz.create_summary_table(pd.DataFrame(rows), output_dir=tmp_path / "jax")
    got = pviz.create_summary_table(rows, output_dir=tmp_path / "port")
    assert got.rows == want.index.tolist() and got.columns == want.columns.tolist()
    np.testing.assert_array_equal(got.values, want.to_numpy())
    for name in ("sliced_wasserstein_summary.csv", "sliced_wasserstein.tex"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    with pytest.raises(ValueError, match="No data found"):
        pviz.create_summary_table(rows, "Marginal Wasserstein")


@pytest.mark.parametrize("case", ["dataset-backbone", "dataset", "ungrouped", "single-runs"])
def test_results_to_latex_bytes(case):
    rng = np.random.default_rng(5)
    rows = []
    for i in range(7):
        row = {"run_id": f"r{i}", "dataset": ["ecg", "nasa", "ecg", "aaa"][i % 4],
               "backbone": ["transformer", "lstm"][i % 2]}
        for m in jres.PRIMARY_METRICS[: 2 + i % 3]:
            row[m] = float(rng.uniform(0, 2)) if i != 3 else 1.0005
        rows.append(row)
    if case == "dataset":
        rows = [{k: v for k, v in r.items() if k != "backbone"} for r in rows]
    elif case == "ungrouped":
        rows = [{k: v for k, v in r.items() if k not in ("backbone", "dataset")} for r in rows]
    elif case == "single-runs":
        rows = rows[:2]  # one run a group: std NaN, written 0.000
    want = jviz.results_to_latex(pd.DataFrame(rows))
    assert pviz.results_to_latex(rows) == want
    metrics = jres.PRIMARY_METRICS[:1]
    assert pviz.results_to_latex(rows, metrics) == jviz.results_to_latex(pd.DataFrame(rows),
                                                                          metrics)


def test_parse_sweep_params_rows():
    methods = ["baseline", "score_R20", "score_tau0.5", "kv_K5", "token_b24", "e2crf_score",
               "score_R", "token_b1.5"]
    rows = [{"method": m, "speedup": float(i)} for i, m in enumerate(methods)]
    got = pbf.parse_sweep_params(rows)
    assert _records(pd.DataFrame(got)) == _records(jbf.parse_sweep_params(pd.DataFrame(rows)))
    assert got[0]["Parameter"] is None and math.isnan(got[0]["Value"])
    assert [r["Parameter"] for r in got] == [None, "R", "tau_0", "K", "token_budget", None,
                                             None, "token_budget"]


def test_spectral_profile_and_analysis(runs, tmp_path):
    runs_dir, run_ids = runs
    values = np.random.default_rng(3).uniform(0, 1, 18).tolist()
    np.testing.assert_allclose(pviz.calculate_spectral_profile(values, 2),
                               jviz.calculate_spectral_profile(values, 2), rtol=1e-12)
    want = jviz.process_spectral_analysis(run_ids, runs_dir, tmp_path / "jax")
    got = pviz.process_spectral_analysis(run_ids, runs_dir, tmp_path / "port")
    assert [{k: v for k, v in r.items() if k != "Spectral Density"} for r in got] == \
        [{k: v for k, v in r.items() if k != "Spectral Density"}
         for r in want.to_dict("records")]
    np.testing.assert_allclose([r["Spectral Density"] for r in got],
                               want["Spectral Density"].to_numpy(), rtol=1e-12)
    assert (tmp_path / "port/spectral_density.csv").read_bytes() == \
        (tmp_path / "jax/spectral_density.csv").read_bytes()
    with pytest.raises(ValueError, match="No spectral data"):
        pviz.process_spectral_analysis(["missing"], runs_dir)


@pytest.fixture(scope="module")
def ecg_tables(tmp_path_factory):
    from fdtpu.data import ECGDatamodule as JaxECG
    from fdtpu.data import fixtures as jfix
    from fdtpu_torch.data import ECGDatamodule

    root = tmp_path_factory.mktemp("ecg")
    jfix.write_ecg_fixture(root)
    want = jviz.process_dataset("ECG", JaxECG(data_dir=root))
    got = pviz.process_dataset("ECG", ECGDatamodule(data_dir=root), device="cpu")
    return want, got


def test_process_dataset_tables_on_the_ecg_fixture(ecg_tables):
    want, got = ecg_tables
    for w, g in zip(want, got):
        assert list(g) == list(w.columns)
        for name in w.columns:
            col = pspec.column(g, name)
            assert len(col) == len(w)
            if w[name].dtype.kind == "f":
                # A standard error (SE) is a spread of shares, which scales the
                # FFTs' float32 differences by their mean over their spread.
                rtol = 2e-6 if name == "SE" else 1e-6
                np.testing.assert_allclose(col, w[name].to_numpy(), rtol=rtol, atol=1e-12,
                                           err_msg=name)
            else:
                assert col.tolist() == w[name].tolist(), name


def test_process_all_dataset_spectra_skips_absent_datasets(tmp_path, caplog):
    from fdtpu_torch.data import ECGDatamodule, fixtures

    fixtures.write_ecg_fixture(tmp_path)
    registry = {"ECG": ECGDatamodule(data_dir=tmp_path),
                "Absent": ECGDatamodule(data_dir=tmp_path / "absent")}
    out = pviz.process_all_dataset_spectra(tmp_path, tmp_path / "out", registry=registry,
                                           device="cpu")
    assert "Skipping Absent" in caplog.text
    assert pspec.column_length(out[2]) == 2 * 29
    assert (tmp_path / "out/localization_joint_datasets.csv").read_text().startswith(
        "Dataset,Delocalization Time,Delocalization Frequency\nECG,")
    with pytest.raises(ValueError, match="No datasets"):
        pviz.process_all_dataset_spectra(tmp_path, registry={"Absent": registry["Absent"]},
                                         device="cpu")


def test_default_dataset_registry_names():
    got = pviz.default_dataset_registry("data")
    want = jviz.default_dataset_registry("data")
    assert list(got) == list(want)
    for name in got:
        assert type(got[name]).__name__ == type(want[name]).__name__
        assert got[name].data_dir == want[name].data_dir


# ----------------------------------------------------------------- figures
@pytest.fixture
def plt():
    return pytest.importorskip("matplotlib.pyplot")


def axes_data(fig) -> list:
    """What a figure shows: per axes its lines, bars, boxes, scatter
    offsets, images and table cells, and its labels."""
    out = []
    for ax in fig.axes:
        out.append(dict(
            lines=[(np.asarray(l.get_xdata(), float), np.asarray(l.get_ydata(), float))
                   for l in ax.get_lines()],
            bars=[(p.get_x(), p.get_y(), p.get_width(), p.get_height()) for p in ax.patches],
            points=[np.asarray(c.get_offsets(), float) for c in ax.collections],
            images=[np.asarray(im.get_array(), float) for im in ax.get_images()],
            tables=[{k: (c.get_text().get_text(), c.get_facecolor())
                     for k, c in t.get_celld().items()} for t in ax.tables],
            text=(ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                  [t.get_text() for t in ax.get_xticklabels()]),
        ))
    return out


def assert_same_figure(got, want, rtol=1e-6):
    g, w = axes_data(got), axes_data(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a["text"] == b["text"] and a["tables"] == b["tables"]
        for key in ("lines", "bars", "points", "images"):
            assert len(a[key]) == len(b[key]), key
            for x, y in zip(a[key], b[key]):
                np.testing.assert_allclose(np.asarray(x, float), np.asarray(y, float),
                                           rtol=rtol, err_msg=key)
    import matplotlib.pyplot

    matplotlib.pyplot.close("all")


def test_results_figures(runs, plt):
    runs_dir, run_ids = runs
    assert_same_figure(pviz.plot_sample_quality(pviz.process_results(runs_dir)),
                       jviz.plot_sample_quality(jviz.process_results(runs_dir)))
    jm, jb = jviz.process_run_metrics(run_ids, runs_dir)
    pm, pb = pviz.process_run_metrics(run_ids, runs_dir)
    got, want = pviz.plot_quality_boxes(pm, pb), jviz.plot_quality_boxes(jm, jb)
    assert len(got) == len(want) == 2 * 4  # two metrics, four datasets
    for g, w in zip(got, want):
        assert_same_figure(g, w)
    got = pviz.plot_run_spectral_density(pviz.process_spectral_analysis(run_ids, runs_dir))
    want = jviz.plot_run_spectral_density(jviz.process_spectral_analysis(run_ids, runs_dir))
    for g, w in zip(got, want, strict=True):
        assert_same_figure(g, w)
    plt.close("all")


def test_results_pipelines_write_the_jax_files(runs, tmp_path, plt):
    runs_dir, run_ids = runs
    for name, viz in (("port", pviz), ("jax", jviz)):
        viz.results_main(run_ids, runs_dir, tmp_path / name / "main")
        viz.process_all_datasets(runs_dir, tmp_path / name / "all")
    files = {name: sorted(p.relative_to(tmp_path / name)
                          for p in (tmp_path / name).rglob("*") if p.is_file())
             for name in ("port", "jax")}
    assert files["port"] == files["jax"]
    assert len(files["port"]) == 2 + 4 + 8 + 1 + 3 + 1 + 4 + 2
    for rel in files["port"]:
        if rel.suffix in (".csv", ".tex"):
            assert (tmp_path / "port" / rel).read_bytes() == \
                (tmp_path / "jax" / rel).read_bytes(), rel


def _figures_of(module, monkeypatch, plt):
    shown = []
    monkeypatch.setattr(module, "_save", lambda fig, d, stem: shown.append((stem, fig)))
    monkeypatch.setattr(plt, "close", lambda fig: None)
    return shown


def test_benchmark_figures(tmp_path, monkeypatch, plt):
    rng = np.random.default_rng(7)
    methods = ["baseline", "baseline_self(noise floor)", "e2crf_score", "e2crf_token",
               "score_R5", "score_R50", "score_R20", "score_tau0.5", "score_tau1.0",
               "kv_K5", "kv_K0", "token_b16", "token_b48"]
    rows = []
    for m in methods:
        row = {"method": m, "time_s": float(rng.uniform(0.5, 3)),
               "samples_per_s": float(rng.uniform(1, 9))}
        if m != "baseline":
            row["speedup"] = float(rng.uniform(0.5, 3))
        if m.startswith(("e2crf", "score", "kv", "token")):
            row["cache_cache_hit_ratio"] = float(rng.uniform(0, 1))
            row["cache_steps_skipped_ratio"] = float(rng.uniform(0, 1))
            row["sw_vs_baseline"] = float(rng.uniform(0, 1))
        rows.append(row)
    shown = {}
    for name, module, table in (("jax", jbf, pd.DataFrame(rows)), ("port", pbf, rows)):
        shown[name] = _figures_of(module, monkeypatch, plt)
        module.create_benchmark_figures(table, tmp_path / name, model_id="m")
    assert [s for s, _ in shown["port"]] == [s for s, _ in shown["jax"]]
    assert len(shown["port"]) == 8
    for (_, g), (_, w) in zip(shown["port"], shown["jax"]):
        assert_same_figure(g, w)
    payload = {"shapes": {"ecg": {"speedup": 3.1, "max_len": 187, "n_channels": 1,
                                  "steps_skipped_ratio": 0.7},
                          "nasa": {"speedup": 2.2, "max_len": 251, "n_channels": 4},
                          "none": {"speedup": None}}}
    shown = {}
    for name, module in (("jax", jbf), ("port", pbf)):
        shown[name] = _figures_of(module, monkeypatch, plt)
        assert module.shape_scaling_figure(payload, tmp_path / name).name == "shape_scaling.pdf"
        assert module.shape_scaling_figure({"shapes": {}}, tmp_path / name) is None
    assert_same_figure(shown["port"][0][1], shown["jax"][0][1])


def test_spectral_figures(ecg_tables, plt):
    want, got = ecg_tables
    x = np.random.default_rng(1).normal(size=(12, 24, 2)).astype(np.float32)
    y = np.random.default_rng(2).normal(size=(10, 24, 2)).astype(np.float32)
    assert_same_figure(pviz.plot_spectral_density(x, other=y, channel=1, device="cpu"),
                       jviz.plot_spectral_density(x, other=y, channel=1), rtol=1e-5)
    assert_same_figure(pviz.plot_temporal_energy(x, channel=1),
                       jviz.plot_temporal_energy(x, channel=1))
    assert_same_figure(pviz.plot_delocalization({"a": x, "b": y}, device="cpu"),
                       jviz.plot_delocalization({"a": x, "b": y}), rtol=1e-5)
    assert_same_figure(pviz.plot_localization_bars(got[2]), jviz.plot_localization_bars(want[2]),
                       rtol=1e-5)
    assert_same_figure(pviz.plot_localization_joint(got[3]),
                       jviz.plot_localization_joint(want[3]), rtol=1e-5)


def test_spectral_interpretation_main(tmp_path, plt):
    from fdtpu_torch.data import ECGDatamodule, fixtures

    fixtures.write_ecg_fixture(tmp_path)
    pviz.spectral_interpretation_main(tmp_path, tmp_path / "out",
                                      registry={"ECG": ECGDatamodule(data_dir=tmp_path)},
                                      device="cpu")
    assert {p.name for p in (tmp_path / "out/figures").iterdir()} == {
        "spectral_density_datasets.pdf", "temporal_energy_datasets.pdf",
        "localization_datasets.pdf", "localization_joint_datasets.png"}


@pytest.fixture(scope="module")
def sample_runs(tmp_path_factory):
    """Two runs with ``samples.npy`` and the composed train config of a
    small synthetic datamodule, for each package (each its data directory:
    the packages store the generated series in other formats)."""
    from fdtpu.utils.config import compose_config

    root = tmp_path_factory.mktemp("sample_runs")
    for package in ("jax", "port"):
        cfg = compose_config(Path(__file__).resolve().parents[1] / "configs", "train", [
            "datamodule=synthetic", "datamodule.max_len=20", "datamodule.num_samples=24",
            f"datamodule.data_dir={root / package / 'data'}"])
        for i, run_id in enumerate(("run_freq", "run_time")):
            (root / package / run_id).mkdir(parents=True)
            (root / package / run_id / "train_config.yaml").write_text(yaml.safe_dump(cfg))
            np.save(root / package / run_id / "samples.npy",
                    np.random.default_rng(i).normal(size=(7, 20, 1)))
    return root, {"freq": "run_freq", "time": "run_time", "absent": "nowhere"}


def test_load_samples_and_train_samples(sample_runs):
    root, ids = sample_runs
    with pytest.warns(UserWarning, match="samples not found"):
        got = pviz.load_samples(ids, root / "port", random_seed=3)
    with pytest.warns(UserWarning, match="samples not found"):
        want = jviz.load_samples(ids, root / "jax", random_seed=3)
    assert list(got) == list(want) == ["freq", "time", "train"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(pviz.get_train_samples("run_freq", root / "port"),
                                  jviz.get_train_samples("run_freq", root / "jax"))


def test_sample_figures(sample_runs, tmp_path, plt):
    root, ids = sample_runs
    runs_dir = root / "port"
    samples = np.random.default_rng(4).normal(size=(9, 20, 3))
    ref = np.random.default_rng(5).normal(size=(4, 20, 3))
    assert_same_figure(pviz.plot_sample_lines(samples, reference=ref, channel=2),
                       jviz.plot_sample_lines(samples, reference=ref, channel=2))
    assert_same_figure(pviz.plot_sample_heatmap(samples, n_examples=5),
                       jviz.plot_sample_heatmap(samples, n_examples=5))
    grid = {"time": samples, "train": ref, "freq": samples[::-1]}
    assert_same_figure(pviz.plot_samples_grid(grid, 3)[0], jviz.plot_samples_grid(grid, 3)[0])
    assert_same_figure(pviz.heatmap_samples_grid(grid, 2)[0],
                       jviz.heatmap_samples_grid(grid, 2)[0])
    ids = {k: v for k, v in ids.items() if k != "absent"}
    paths = pviz.visualize_model_comparison(ids, runs_dir, tmp_path, dataset_name="syn",
                                          n_samples=2)
    assert [p.name for p in paths] == ["syn_samples_line.png", "syn_samples_heatmap.png"]
    assert all(p.exists() for p in paths)
    assert [p.name for p in pviz.visualize_samples(runs_dir / "run_time")] == [
        "samples_lines.png", "samples_heatmap.png"]


def test_viz_exports_the_jax_names():
    assert sorted(pviz.__all__) == sorted(jviz.__all__)
    for name in jviz.__all__:
        assert callable(getattr(pviz, name)), name
