"""Raw-file trees with the real datasets' schemas, written with numpy and the
``csv`` module (port of ``fdtpu/data/fixtures.py:33-150``, and of
``mimic_fixture_frames`` as :class:`~fdtpu_torch.data.hdf_fixed.Table` s,
and of ``write_mimic_fixture``, which writes them as ``all_hourly_data.h5``).

Each writer draws the JAX package's values from the same seed in the same
order, and its files parse to the same arrays under both packages'
datamodules, so the whole ``prepare_data → setup`` pipeline runs on a machine
without pandas or network.  The values are uniform noise: they test the
plumbing and the schema, not the statistics of the real data.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from fdtpu_torch.data.hdf_fixed import Table, write_fixed_frame

__all__ = [
    "mimic_fixture_tables",
    "write_droughts_fixture",
    "write_ecg_fixture",
    "write_mimic_fixture",
    "write_nasa_fixture",
    "write_nasdaq_fixture",
]


def _write_rows(path: Path, header: list[str], rows) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)


def _day(d: np.datetime64) -> str:
    return str(d.astype("datetime64[D]"))


def write_ecg_fixture(root: Path, n_train: int = 30, n_test: int = 10, seed: int = 0) -> Path:
    """MIT-BIH CSVs: 188 columns (187 samples, then the class label) and no
    header, so the datamodules drop the first row, as the JAX package's
    pandas default header does.  Values are written to 9 significant
    digits, which round-trips float32."""
    d = Path(root) / "ecg"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name, n in (("mitbih_train.csv", n_train), ("mitbih_test.csv", n_test)):
        vals = rng.uniform(0, 1, size=(n, 187)).astype(np.float32)
        labels = rng.integers(0, 5, size=(n, 1)).astype(np.float32)
        np.savetxt(d / name, np.hstack([vals, labels]), fmt="%.9g", delimiter=",")
    return d


def _business_days(start: str, count: int) -> np.ndarray:
    days = np.arange(np.datetime64(start), np.datetime64(start) + 2 * count, dtype="datetime64[D]")
    return days[np.is_busday(days)][:count]


def write_nasdaq_fixture(root: Path, n_stocks: int = 3, seed: int = 1,
                         with_holey_stock: bool = True) -> Path:
    """Per-stock CSVs (Date, Open, High, Low, Close, Adj Close, Volume); only
    the stocks spanning 2019 with exactly 252 trading days pass the filter."""
    d = Path(root) / "nasdaq"
    (d / "stocks").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    days_2019 = _business_days("2019-01-02", 252)
    dates = [_day(x) for x in
             [np.datetime64("2018-12-28"), *days_2019, np.datetime64("2020-01-02")]]
    header = ["Date", "Open", "High", "Low", "Close", "Adj Close", "Volume"]
    n = len(dates)
    rows: list = []
    for i in range(n_stocks):
        name = "".join(chr(ord("A") + (i + j) % 26) for j in range(4))
        columns = [rng.uniform(10, 20, n), rng.uniform(20, 30, n), rng.uniform(5, 10, n),
                   rng.uniform(10, 20, n), rng.uniform(10, 20, n)]
        volume = rng.integers(1000, 2000, n)
        rows = [[day, *(repr(float(c[k])) for c in columns), int(volume[k])]
                for k, day in enumerate(dates)]
        _write_rows(d / "stocks" / f"{name}.csv", header, rows)
    if with_holey_stock and rows:
        # A stock with 251 days in 2019, which the filter must drop.
        _write_rows(d / "stocks" / "HOLE.csv", header, rows[:-2])
    return d


def write_nasa_fixture(root: Path, n_files: int = 3, seed: int = 2, kind: str = "charge") -> Path:
    """``cleaned_dataset/metadata.csv`` and a CSV per cycle, sampled every
    5 s past both subsets' cutoffs."""
    d = Path(root) / "nasa"
    (d / "cleaned_dataset" / "data").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    files = [f"{i:05d}.csv" for i in range(n_files)]
    other = "discharge" if kind == "charge" else "charge"
    _write_rows(d / "cleaned_dataset" / "metadata.csv", ["type", "filename", "battery_id"],
                [[kind, f, "B05"] for f in files] + [[other, "99999.csv", "B05"]])
    t = np.arange(0, 5100, 5.0)
    extra = ("Current_charge", "Voltage_charge") if kind == "charge" else (
        "Current_load", "Voltage_load")
    header = ["Voltage_measured", "Current_measured", "Temperature_measured", *extra, "Time"]
    for f in files:
        columns = [rng.uniform(3, 4, len(t)), rng.uniform(-1, 2, len(t)),
                   rng.uniform(20, 40, len(t)), rng.uniform(0, 2, len(t)),
                   rng.uniform(4, 5, len(t)), t]
        _write_rows(d / "cleaned_dataset" / "data" / f, header,
                    [[repr(float(c[k])) for c in columns] for k in range(len(t))])
    return d


DROUGHT_FEATURES = ["PRECTOT", "PS", "QV2M", "T2M", "T2MDEW", "T2MWET", "T2M_MAX",
                    "T2M_MIN", "T2M_RANGE", "TS", "WS10M", "WS50M"]


def write_droughts_fixture(root: Path, fips: tuple = (1001, 1003, 1005, 1007, 1009, 1011),
                           seed: int = 3) -> Path:
    """``train_timeseries.csv``: daily county meteorology and a weekly
    drought score, missing except on Tuesdays, which the pipeline's
    ``dropna(axis=1)`` removes."""
    d = Path(root) / "droughts"
    (d / "train_timeseries").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    dates = np.arange(np.datetime64("2010-12-25"), np.datetime64("2012-01-11"),
                      dtype="datetime64[D]")
    rows = []
    for county in fips:
        for date in dates:
            row = [county, _day(date)] + [repr(rng.uniform(0, 10)) for _ in DROUGHT_FEATURES]
            tuesday = (date.astype(np.int64) + 3) % 7 == 1  # 1970-01-01 was a Thursday
            row.append(repr(rng.uniform(0, 5)) if tuesday else "")
            rows.append(row)
    _write_rows(d / "train_timeseries" / "train_timeseries.csv",
                ["fips", "date", *DROUGHT_FEATURES, "score"], rows)
    return d


def mimic_fixture_tables(n_features: int = 104, n_subjects: int = 6, hours: int = 30,
                         seed: int = 4) -> tuple[Table, Table]:
    """MIMIC-Extract-shaped ``(statics, vitals_labs)`` tables, the values of
    the JAX package's ``mimic_fixture_frames``: rows by subject, admission,
    stay (and hour), ``(LEVEL2, Aggregation Function)`` columns in
    mean/count pairs, 30% of the measurements missing."""
    rng = np.random.default_rng(seed)
    sub = np.arange(n_subjects)
    ids = {"subject_id": sub, "hadm_id": sub + 100, "icustay_id": sub + 200}
    statics = Table(
        index=ids, columns=["max_hours", "mort_hosp", "mort_icu", "los_icu"],
        column_names=[None],
        data=[np.full(n_subjects, hours + 10), rng.integers(0, 2, n_subjects),
              rng.integers(0, 2, n_subjects), rng.uniform(1, 5, n_subjects)])
    index = {k: np.repeat(v, hours) for k, v in ids.items()}
    index["hours_in"] = np.tile(np.arange(hours), n_subjects)
    columns = [(f"feat{i}", agg) for i in range(n_features) for agg in ("mean", "count")]
    vals = rng.uniform(0, 1, size=(n_subjects * hours, len(columns)))
    mask = rng.uniform(size=(n_subjects * hours, n_features)) < 0.3
    vals[:, 0::2][mask] = np.nan
    vals[:, 1::2][mask] = 0.0
    vitals = Table(index=index, columns=columns,
                   column_names=["LEVEL2", "Aggregation Function"], data=list(vals.T))
    return statics, vitals


def write_mimic_fixture(root: Path, n_features: int = 104, n_subjects: int = 6,
                        seed: int = 4) -> Path:
    """``mimiciii/all_hourly_data.h5``: the fixture tables as pandas'
    fixed-format frames ``patients`` and ``vitals_labs`` (needs h5py, so it
    runs on a machine that has it, not on the GPU machine)."""
    d = Path(root) / "mimiciii"
    d.mkdir(parents=True, exist_ok=True)
    statics, vitals = mimic_fixture_tables(n_features=n_features, n_subjects=n_subjects,
                                           seed=seed)
    path = d / "all_hourly_data.h5"
    write_fixed_frame(statics, path, "patients", mode="w")
    write_fixed_frame(vitals, path, "vitals_labs")
    return d
