"""Port parity of the real datasets: ``fdtpu_torch.data`` (numpy and the csv
module, no pandas) against ``fdtpu.data`` (pandas) on the schema fixtures.

Each dataset's raw tree is written twice, by the JAX package's writers and
by the port's, and read by both packages' datamodules: the arrays must be
bitwise equal (ECG's labels too), as must the dataset parameters, the
feature statistics and the first train batch.  MIMIC runs through its frame
pipeline and through the ``.h5`` reader.  The spectral ops are held to
``fdtpu.ops`` at odd and even lengths at rtol 1e-5, atol 1e-6 (two float32
FFTs), and so is ECG's frequency smoothing.
"""

import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import fdtpu.data as jdata
from fdtpu.data import fixtures as jfix
from fdtpu.data.hdf_fixed import read_fixed_frame as jax_read_fixed_frame
from fdtpu.data.preprocessing import mimic_preprocess_frames as jax_mimic_frames
from fdtpu.ops import localization_metrics as jax_localization_metrics
from fdtpu.ops import smooth_frequency as jax_smooth_frequency
import fdtpu_torch.data as pdata
from fdtpu_torch.data import fixtures as pfix
from fdtpu_torch.data import preprocessing as pre
from fdtpu_torch.data.hdf_fixed import read_fixed_frame
from fdtpu_torch.ops import localization_metrics, smooth_frequency

# name → (writer, datamodule class name, writer kwargs, datamodule kwargs)
DATASETS = {
    "ecg": ("write_ecg_fixture", "ECGDatamodule", {}, {}),
    "nasdaq": ("write_nasdaq_fixture", "NASDAQDatamodule", {}, {}),
    "nasa-charge": ("write_nasa_fixture", "NASADatamodule", {}, {"subdataset": "charge"}),
    "nasa-discharge": ("write_nasa_fixture", "NASADatamodule", {"kind": "discharge"},
                       {"subdataset": "discharge"}),
    "droughts": ("write_droughts_fixture", "USDroughtsDatamodule", {}, {}),
}
SPECTRAL_TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(tmp_path, dataset, writer_pkg, standardize=True, fourier=False, **extra):
    """The dataset's tree written by ``writer_pkg``'s writer, read by both
    packages' datamodules (each in its own copy of the tree)."""
    writer, cls, wkw, kw = DATASETS[dataset]
    write = getattr(jfix if writer_pkg == "jax" else pfix, writer)
    dms = []
    for pkg, module in (("jax", jdata), ("port", pdata)):
        write(tmp_path / pkg, **wkw)
        dm = getattr(module, cls)(data_dir=tmp_path / pkg, batch_size=2, random_seed=7,
                                  standardize=standardize, fourier_transform=fourier,
                                  **kw, **extra)
        dm.prepare_data()
        dm.setup("fit")
        dms.append(dm)
    return dms


def _assert_same(j, p):
    for a, b in ((j.X_train, p.X_train), (j.X_test, p.X_test)):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer_pkg", ["jax", "port"])
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_datamodule_arrays_are_bitwise_the_jax_ones(tmp_path, dataset, writer_pkg):
    j, p = _pair(tmp_path, dataset, writer_pkg)
    _assert_same(j, p)
    assert len(p.X_train) > 0 and np.isfinite(p.X_train).all()
    if dataset == "ecg":
        assert p.X_train.shape == (29, 187, 1)  # the header quirk: one row dropped
        for a, b in ((j.y_train, p.y_train), (j.y_test, p.y_test)):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
        item, jax_item = p.train_dataloader().dataset[3], j.train_dataloader().dataset[3]
        assert set(item) == set(jax_item) == {"X", "y"} and item["y"] == jax_item["y"]
        np.testing.assert_array_equal(item["X"], jax_item["X"])
    assert p.dataset_parameters == j.dataset_parameters
    for a, b in zip(p.feature_mean_and_std, j.feature_mean_and_std):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(next(iter(p.train_dataloader())),
                                  next(iter(j.train_dataloader())))
    np.testing.assert_array_equal(next(iter(p.val_dataloader())),
                                  next(iter(j.val_dataloader())))


@pytest.mark.parametrize("dataset", ["ecg", "nasa-charge"])
def test_frequency_domain_batches_match_jax(tmp_path, dataset):
    """With ``fourier_transform`` the arrays stay bitwise; the statistics and
    batches go through each package's float32 DFT: the statistics within
    rtol 1e-5 and an atol of 1e-6 of the spectrum's largest magnitude (NASA's
    reaches ~55), the standardized batches within 1e-4."""
    j, p = _pair(tmp_path, dataset, "port", fourier=True)
    _assert_same(j, p)
    scale = float(np.abs(j.train_dataloader().dataset.X).max())
    for a, b in zip(p.feature_mean_and_std, j.feature_mean_and_std):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(next(iter(p.train_dataloader())),
                               next(iter(j.train_dataloader())), rtol=1e-4, atol=1e-4)


def test_writers_draw_the_jax_values(tmp_path):
    """The port's files parse to the JAX package's arrays under pandas too."""
    for name in ("write_nasdaq_fixture", "write_droughts_fixture", "write_nasa_fixture"):
        getattr(jfix, name)(tmp_path / "jax")
        getattr(pfix, name)(tmp_path / "port")
    for rel in ("nasdaq/stocks/ABCD.csv", "nasdaq/stocks/HOLE.csv",
                "droughts/train_timeseries/train_timeseries.csv",
                "nasa/cleaned_dataset/metadata.csv", "nasa/cleaned_dataset/data/00001.csv"):
        a, b = pd.read_csv(tmp_path / "jax" / rel), pd.read_csv(tmp_path / "port" / rel)
        pd.testing.assert_frame_equal(a, b)


def test_nasdaq_features_are_in_pivot_order(tmp_path):
    """pivot_table sorts the value columns by name: Adj Close, Close, High,
    Low, Open, Volume; the datamodule drops the last (Volume)."""
    root = pfix.write_nasdaq_fixture(tmp_path, n_stocks=2, with_holey_stock=False)
    pre.nasdaq_preprocess(root, random_seed=0, train_frac=1.0)
    x = np.load(root / "X_train.npy")
    assert x.shape == (2, 252, 6)
    table = pd.read_csv(root / "stocks" / "ABCD.csv")
    day = table[table["Date"] == "2019-01-02"]
    row = x[[i for i in range(2) if np.isclose(x[i, 0, 3], day["Low"].iloc[0])][0], 0]
    expected = day[["Adj Close", "Close", "High", "Low", "Open", "Volume"]].to_numpy()[0]
    np.testing.assert_array_equal(row, expected.astype(np.float32))


# ----------------------------------------------------------------- MIMIC-III
def _table(frame: pd.DataFrame) -> pre.Table:
    return pre.Table(
        index={n: frame.index.get_level_values(n).to_numpy() for n in frame.index.names},
        columns=list(frame.columns), column_names=list(frame.columns.names),
        data=[frame.iloc[:, i].to_numpy() for i in range(frame.shape[1])])


@pytest.mark.parametrize("n_features, n_subjects, seed", [(12, 6, 0), (104, 20, 3), (7, 40, 5)])
def test_mimic_frames_pipeline_is_bitwise_the_jax_one(tmp_path, n_features, n_subjects, seed):
    statics, vitals = jfix.mimic_fixture_frames(n_features=n_features, n_subjects=n_subjects)
    for d in ("jax", "port", "tables"):
        (tmp_path / d).mkdir()
    jax_mimic_frames(statics, vitals, tmp_path / "jax", random_seed=seed,
                     expected_features=n_features)
    pre.mimic_preprocess_frames(_table(statics), _table(vitals), tmp_path / "port",
                                random_seed=seed, expected_features=n_features)
    # The port's own fixture tables hold the JAX frames' values.
    pre.mimic_preprocess_frames(*pfix.mimic_fixture_tables(n_features=n_features,
                                                           n_subjects=n_subjects),
                                tmp_path / "tables", random_seed=seed,
                                expected_features=n_features)
    for split in ("train", "test"):
        a = np.load(tmp_path / "jax" / f"X_{split}.npy")
        for d in ("port", "tables"):
            b = np.load(tmp_path / d / f"X_{split}.npy")
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_mimic_h5_datamodule_is_bitwise_the_jax_one(tmp_path):
    j_root, p_root = tmp_path / "jax", tmp_path / "port"
    jfix.write_mimic_fixture(j_root, n_features=104, n_subjects=10)
    shutil.copytree(j_root, p_root)
    j = jdata.MIMICIIIDatamodule(data_dir=j_root, batch_size=2, n_feats=40, standardize=True)
    p = pdata.MIMICIIIDatamodule(data_dir=p_root, batch_size=2, n_feats=40, standardize=True)
    for dm in (j, p):
        dm.prepare_data()
        dm.setup("fit")
    _assert_same(j, p)
    assert p.dataset_parameters == j.dataset_parameters == {
        "n_channels": 40, "max_len": 24, "num_training_steps": 4}
    np.testing.assert_array_equal(next(iter(p.train_dataloader())),
                                  next(iter(j.train_dataloader())))


def test_hdf_reader_reads_what_the_jax_reader_reads(tmp_path):
    root = jfix.write_mimic_fixture(tmp_path, n_features=5, n_subjects=3)
    for key in ("patients", "vitals_labs"):
        frame = jax_read_fixed_frame(root / "all_hourly_data.h5", key)
        table = read_fixed_frame(root / "all_hourly_data.h5", key)
        assert table.columns == list(frame.columns)
        assert table.column_names == list(frame.columns.names)
        assert list(table.index) == list(frame.index.names)
        for name in frame.index.names:
            np.testing.assert_array_equal(table.index[name],
                                          frame.index.get_level_values(name).to_numpy())
        for i, column in enumerate(table.data):
            np.testing.assert_array_equal(column, frame.iloc[:, i].to_numpy())


def test_hdf_reader_without_h5py_says_where_to_prepare(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="needs h5py"):
        read_fixed_frame(tmp_path / "all_hourly_data.h5", "patients")


# ----------------------------------------------------------------- pandas' arithmetic
def test_group_mean_is_pandas_groupby_mean():
    rng = np.random.default_rng(0)
    labels = rng.integers(-1, 7, 300)
    values = rng.normal(size=(300, 3)) * 10.0 ** rng.integers(-8, 8, (300, 3))
    values[rng.uniform(size=values.shape) < 0.2] = np.nan
    values[5, 0], values[9, 1] = np.inf, -np.inf
    values[labels == 3, 2] = np.nan  # a group with no measurement
    frame = pd.DataFrame(values)
    frame["g"] = np.where(labels < 0, np.nan, labels)
    expected = frame.groupby("g").mean().reindex(range(8)).to_numpy()
    np.testing.assert_array_equal(pre.group_mean(labels, values, 8), expected)


def test_pivot_mean_is_pandas_pivot_table():
    rng = np.random.default_rng(1)
    n = 200
    rows = rng.choice(["b", "a", "c", "d"], n)
    cols = rng.integers(0, 9, n)
    values = rng.normal(size=(n, 3))
    values[rng.uniform(size=values.shape) < 0.3] = np.nan
    values[rows == "d"] = np.nan  # a row key with no value at all
    names = ["Open", "Adj Close", "zeta"]
    frame = pd.DataFrame(values, columns=names)
    frame["r"], frame["c"] = rows, cols
    expected = frame.pivot_table(index="r", columns="c", values=names)
    table, keys = pre.pivot_mean(rows, cols, values, names)
    assert list(keys) == list(expected.index)
    np.testing.assert_array_equal(table, expected.to_numpy())


def test_column_mean_and_std_are_pandas():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(50, 6)) * 1e3
    x[rng.uniform(size=x.shape) < 0.3] = np.nan
    x[:, 5] = np.nan
    x[3, 5] = 1.0  # one measurement: std NaN
    mean, std = pre._column_mean_std(x)
    frame = pd.DataFrame(x)
    np.testing.assert_array_equal(mean, frame.mean(axis=0).to_numpy())
    np.testing.assert_array_equal(std, frame.std(axis=0).to_numpy())


# ----------------------------------------------------------------- spectral ops
@pytest.mark.parametrize("length", [187, 20, 21, 8])
def test_localization_metrics_match_jax(length):
    x = np.random.default_rng(length).normal(size=(6, length, 2)).astype(np.float32)
    expected = jax_localization_metrics(jnp.asarray(x))
    got = localization_metrics(torch.from_numpy(x))
    for a, b in zip(got, expected):
        assert a.shape == (6,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SPECTRAL_TOL)


@pytest.mark.parametrize("length, sigma", [(187, 5.0), (20, 2.0), (21, 3.0), (8, 0.5)])
def test_smooth_frequency_matches_jax(length, sigma):
    x = np.random.default_rng(length).normal(size=(4, length, 3)).astype(np.float32)
    got = smooth_frequency(torch.from_numpy(x), sigma)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_smooth_frequency(jnp.asarray(x), sigma)),
                               **SPECTRAL_TOL)


def _ecg_pair(tmp_path, n_train, **options):
    dms = []
    for pkg, module in (("jax", jdata), ("port", pdata)):
        jfix.write_ecg_fixture(tmp_path / pkg, n_train=n_train, n_test=10)
        dm = module.ECGDatamodule(data_dir=tmp_path / pkg, batch_size=4, **options)
        dm.setup("fit")
        dms.append(dm)
    return dms


def test_ecg_subsample_keeps_the_jax_series(tmp_path):
    """At the fixture's 29 rows the ranking is the JAX one, so the kept
    series and their order are bitwise the JAX package's."""
    j, p = _ecg_pair(tmp_path, 30, subsample_localization=True)
    _assert_same(j, p)
    np.testing.assert_array_equal(p.y_train, j.y_train)


def test_ecg_subsample_keeps_the_same_thousand(tmp_path):
    """Past 1000 rows the same 1000 series are kept.  Their order follows
    the scores, which two float32 FFTs give within 1e-6: a near-tie may
    swap two neighbours, so the order is not compared."""
    j, p = _ecg_pair(tmp_path, 1201, subsample_localization=True)
    assert p.X_train.shape == j.X_train.shape == (1000, 187, 1)
    order_j = np.lexsort(j.X_train[:, :, 0].T)
    order_p = np.lexsort(p.X_train[:, :, 0].T)
    np.testing.assert_array_equal(p.X_train[order_p], j.X_train[order_j])
    np.testing.assert_array_equal(p.y_train[order_p], j.y_train[order_j])


def test_ecg_smoothing_matches_jax(tmp_path):
    j, p = _ecg_pair(tmp_path, 30, smooth_frequency=True, smoother_width=4.0)
    for a, b in ((p.X_train, j.X_train), (p.X_test, j.X_test)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, **SPECTRAL_TOL)
