"""Raw-data pipelines of the real datasets in numpy and the ``csv`` module
(port of ``fdtpu/data/preprocessing.py``).

The JAX package runs these through pandas; the GPU machine has no pandas, so
each pipeline is written out over arrays, following what pandas does step by
step, so that the tensors are those of the JAX package bit for bit:

* ``pivot_table`` groups by its keys sorted, averages the duplicates of a
  key and sorts the value columns by name (``Adj Close, Close, High, Low,
  Open, Volume``; ``PRECTOT`` before lower-case names), then drops the
  columns that are NaN everywhere;
* a group mean is pandas' ``group_mean``, a Kahan-compensated sum over the
  group's non-NaN values in row order (:func:`group_mean`);
* ``pd.cut`` bins are right-closed, and ``groupby(observed=False)`` keeps an
  empty bin as NaN;
* a column's ``mean``/``std`` skip NaN, the ``std`` with ddof 1.

Tensors are saved as float32 ``.npy`` files; a torch ``.pt`` file is read
where no ``.npy`` is.  Train/test splits are the JAX package's seeded
``np.random.default_rng(seed).permutation``.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from fdtpu_torch.data.hdf_fixed import Table, read_fixed_frame

# The strings pandas' CSV reader takes for a missing value.
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


def save_split(data_dir: Path, X: np.ndarray, train_frac: float, seed: int) -> None:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(X))
    n_train = int(train_frac * len(X))
    data_dir.mkdir(parents=True, exist_ok=True)
    np.save(data_dir / "X_train.npy", X[perm[:n_train]].astype(np.float32))
    np.save(data_dir / "X_test.npy", X[perm[n_train:]].astype(np.float32))


def load_tensor(path_base: Path) -> np.ndarray:
    """Load ``<base>.npy``, else a torch ``<base>.pt``."""
    npy = path_base.with_suffix(".npy")
    if npy.exists():
        return np.load(npy)
    pt = path_base.with_suffix(".pt")
    if pt.exists():
        return torch.load(pt, map_location="cpu", weights_only=False).numpy()
    raise FileNotFoundError(f"Neither {npy} nor {pt} exists")


# ----------------------------------------------------------------- helpers
def read_csv(path: Path) -> tuple[list[str], list[list[str]]]:
    """A CSV file's header and its rows as strings."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        return header, [row for row in reader if row]


def to_float(values: Iterable[str]) -> np.ndarray:
    """Strings to float64; pandas' missing-value strings become NaN."""
    return np.array([np.nan if v in NA_STRINGS else float(v) for v in values], np.float64)


def to_datetime(values: Iterable[str]) -> np.ndarray:
    """ISO dates (``2019-01-02``, with or without a time) to ``datetime64[s]``."""
    return np.array(list(values), dtype="datetime64[s]")


def group_mean(labels: np.ndarray, values: np.ndarray, n_groups: int) -> np.ndarray:
    """``(n_groups, K)`` means of ``values (N, K)`` by ``labels (N,)`` as
    pandas' ``group_mean`` computes them: a Kahan sum over each group's
    non-NaN values in row order, divided by their count; NaN for a group
    with none; rows labelled < 0 are left out."""
    values = np.asarray(values, np.float64)
    keep = labels >= 0
    labels, values = labels[keep], values[keep]
    order = np.argsort(labels, kind="stable")
    labels, values = labels[order], values[order]
    starts = np.searchsorted(labels, np.arange(n_groups))
    position = np.arange(len(labels)) - starts[labels]
    sums = np.zeros((n_groups, values.shape[1]))
    comp = np.zeros_like(sums)
    nobs = np.zeros_like(sums)
    for p in range(int(position.max()) + 1 if len(position) else 0):
        rows = position == p
        lab, val = labels[rows], values[rows]
        ok = ~np.isnan(val)
        s, c = sums[lab], comp[lab]
        with np.errstate(invalid="ignore"):
            y = val - c
            t = s + y
            c_new = t - s - y
        c_new = np.where(np.isnan(c_new), 0.0, c_new)  # an infinite value
        sums[lab] = np.where(ok, t, s)
        comp[lab] = np.where(ok, c_new, c)
        nobs[lab] += ok
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(nobs > 0, sums / nobs, np.nan)


def _column_mean_std(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """NaN-skipping column mean and std (ddof 1) of ``x (N, C)``, as pandas'
    ``nanmean``/``nanvar`` take them over a frame's column block."""
    xt = np.ascontiguousarray(x.T)
    mask = np.isnan(xt)
    count = (~mask).sum(axis=1).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.where(mask, 0.0, xt).sum(axis=1) / count
        sqr = (mean[:, None] - xt) ** 2
        sqr[mask] = 0.0
        d = count - 1.0
        var = sqr.sum(axis=1) / d
    var[count <= 1] = np.nan
    return mean, np.sqrt(var)


def pivot_mean(
    row_keys: np.ndarray, col_keys: np.ndarray, values: np.ndarray, names: list[str]
) -> tuple[np.ndarray, np.ndarray]:
    """``pivot_table(index=row, columns=col, values=names, aggfunc="mean")``:
    ``(n_rows, n_value_columns)`` with the columns value-major (names sorted)
    and key-minor (keys sorted), and the sorted row keys.  A (row, key) pair
    whose values are all NaN is absent, and a column that is NaN in every row
    is dropped, as pandas' ``dropna=True`` does."""
    rows, row_code = np.unique(row_keys, return_inverse=True)
    cols, col_code = np.unique(col_keys, return_inverse=True)
    pair = row_code * len(cols) + col_code
    pairs, pair_code = np.unique(pair, return_inverse=True)
    means = group_mean(pair_code, values, len(pairs))
    present = ~np.isnan(means).all(axis=1)
    order = np.argsort(names, kind="stable")
    table = np.full((len(rows), len(names), len(cols)), np.nan)
    p_row, p_col = pairs[present] // len(cols), pairs[present] % len(cols)
    table[p_row, :, p_col] = means[present][:, order]
    used_rows = np.isin(np.arange(len(rows)), p_row)
    table = table[used_rows].reshape(int(used_rows.sum()), -1)
    return table[:, ~np.isnan(table).all(axis=0)], rows[used_rows]


# ----------------------------------------------------------------- MIMIC-III
ID_LEVELS = ("subject_id", "hadm_id", "icustay_id")


def _groups(table_index: dict[str, np.ndarray], rows: np.ndarray) -> tuple[np.ndarray, int]:
    """Group label of each selected row by (subject, admission, stay)."""
    keys = np.stack([table_index[k][rows] for k in ID_LEVELS], axis=1)
    _, labels = np.unique(keys, axis=0, return_inverse=True)
    labels = labels.reshape(-1)
    return labels, int(labels.max()) + 1 if len(labels) else 0


def mimic_imputer(means: np.ndarray, labels: np.ndarray, n_groups: int) -> np.ndarray:
    """MIMIC-Extract's imputation of the ``mean`` columns (``fdtpu/data/
    preprocessing.py:43-81``, the columns that reach the tensors): forward
    fill within each stay in row order, then the stay's mean of its measured
    values, then 0.  ``labels`` gives each row's stay."""
    order = np.argsort(labels, kind="stable")
    x = means[order]
    lab = labels[order]
    start = np.searchsorted(lab, lab)  # first row of each row's stay
    pos = np.where(np.isnan(x), -1, np.arange(len(x))[:, None])
    last = np.maximum.accumulate(pos, axis=0)
    filled = np.where(last >= start[:, None], x[np.maximum(last, 0), np.arange(x.shape[1])], np.nan)
    out = np.empty_like(means)
    out[order] = filled
    stay_means = group_mean(labels, means, n_groups)[labels]
    out = np.where(np.isnan(out), stay_means, out)
    return np.where(np.isnan(out), 0.0, out)


def _mean_columns(vitals: Table) -> list[int]:
    """Positions of the ``mean`` columns, ordered by feature name (the JAX
    imputer's closing ``sort_index(axis=1)``)."""
    if len(vitals.column_names) != 2:
        raise ValueError(
            f"expected (LEVEL2, Aggregation Function) columns, got {vitals.column_names}")
    means = [i for i, (_, agg) in enumerate(vitals.columns) if agg == "mean"]
    return sorted(means, key=lambda i: vitals.columns[i])


def mimic_preprocess(data_dir: Path, random_seed: int, train_frac: float = 0.8) -> None:
    """First-24h vitals/labs → ``(N, 24, 104)`` tensors from MIMIC-Extract's
    ``all_hourly_data.h5`` (needs h5py: :mod:`fdtpu_torch.data.hdf_fixed`)."""
    dataset_path = data_dir / "all_hourly_data.h5"
    statics = read_fixed_frame(dataset_path, "patients")
    vitals = read_fixed_frame(dataset_path, "vitals_labs")
    mimic_preprocess_frames(statics, vitals, data_dir, random_seed, train_frac)


def mimic_preprocess_frames(
    statics: Table,
    vitals: Table,
    data_dir: Path,
    random_seed: int,
    train_frac: float = 0.8,
    expected_features: int = 104,
) -> None:
    """The MIMIC pipeline on loaded tables (``fdtpu/data/preprocessing.py:
    116-167``): cohort filter → subject split → standardize with the train
    rows' statistics → impute → ``(N, 24, C)`` float32 tensors."""
    gap_time, window_size = 6, 24
    cohort = statics.index["icustay_id"][statics.column("max_hours") > window_size + gap_time]
    keep = np.flatnonzero(np.isin(vitals.index["icustay_id"], cohort)
                          & (vitals.index["hours_in"] < window_size))

    subjects = np.unique(vitals.index["subject_id"][keep])
    subjects = np.random.default_rng(random_seed).permutation(subjects)
    n_train = int(train_frac * len(subjects))
    cols = _mean_columns(vitals)
    means = np.stack([vitals.data[i] for i in cols], axis=1).astype(np.float64)

    splits = {}
    for name, members in (("train", subjects[:n_train]), ("test", subjects[n_train:])):
        splits[name] = keep[np.isin(vitals.index["subject_id"][keep], members)]
    mu, sigma = _column_mean_std(means[splits["train"]])

    for name, rows in splits.items():
        x = (means[rows] - mu) / sigma
        labels, n_groups = _groups(vitals.index, rows)
        x = mimic_imputer(x, labels, n_groups)
        assert not np.isnan(x).any()
        hours = vitals.index["hours_in"][rows]
        x = np.dstack([x[hours == h] for h in np.unique(hours)]).astype(np.float32)
        x = np.transpose(x, (0, 2, 1))  # (N, time, channel)
        assert x.shape[1:] == (24, expected_features), x.shape
        np.save(data_dir / f"X_{name}.npy", x)


# ----------------------------------------------------------------- NASDAQ
NASDAQ_VALUES = ["Open", "High", "Low", "Close", "Adj Close", "Volume"]


def nasdaq_preprocess(
    data_dir: Path,
    random_seed: int,
    train_frac: float = 0.9,
    start_date: str = "2019-01-01",
    end_date: str = "2020-01-01",
) -> None:
    """Stocks spanning the whole of 2019 with 252 trading days → ``(N, 252,
    6)`` tensors (``fdtpu/data/preprocessing.py:170-204``)."""
    start, end = np.datetime64(start_date, "s"), np.datetime64(end_date, "s")
    names, dates, values = [], [], []
    for path in sorted((data_dir / "stocks").glob("*.csv")):
        header, rows = read_csv(path)
        columns = dict(zip(header, zip(*rows))) if rows else {h: () for h in header}
        date = to_datetime(columns["Date"])
        valid = ~np.isnat(date)
        if not valid.any() or date[valid].min() > start or date[valid].max() < end:
            continue
        window = valid & (date >= start) & (date < end)
        if len(np.unique(date[window])) != 252:
            continue
        names += [path.stem] * int(window.sum())
        dates.append(date[window])
        values.append(np.stack([to_float(columns[v]) for v in NASDAQ_VALUES], axis=1)[window])
    x, _ = pivot_mean(np.array(names), np.concatenate(dates), np.concatenate(values),
                      NASDAQ_VALUES)
    x = x.astype(np.float32)
    x = x.reshape(x.shape[0], -1, 252).transpose(0, 2, 1)  # (stock, day, feature)
    save_split(data_dir, x, train_frac, random_seed)


# ----------------------------------------------------------------- NASA battery
NASA_FEATURES = {
    "charge": (["Voltage_measured", "Current_measured", "Temperature_measured",
                "Current_charge", "Voltage_charge"], 10, 5000 - 5000 % 10),
    "discharge": (["Voltage_measured", "Current_measured", "Temperature_measured",
                   "Current_load", "Voltage_load"], 15, 2000 - 2000 % 15),
}


def nasa_preprocess(
    data_dir: Path,
    subdataset: str = "charge",
    train_frac: float = 0.9,
    random_seed: int = 42,
) -> None:
    """Battery cycles averaged over time bins → ``(N, cutoff/bin + 1, 5)``
    (``fdtpu/data/preprocessing.py:207-261``)."""
    if subdataset not in NASA_FEATURES:
        raise ValueError(f"Unknown subdataset {subdataset}")
    features, interval_bin, cutoff_time = NASA_FEATURES[subdataset]
    edges = np.arange(-interval_bin, cutoff_time + interval_bin, interval_bin)
    num_timesteps = cutoff_time // interval_bin + 1

    header, rows = read_csv(data_dir / "cleaned_dataset" / "metadata.csv")
    meta = dict(zip(header, zip(*rows)))
    files = [f for t, f in zip(meta["type"], meta["filename"]) if t == subdataset]

    binned: dict[str, np.ndarray] = {}
    for filename in files:
        header, rows = read_csv(data_dir / "cleaned_dataset" / "data" / filename)
        columns = dict(zip(header, zip(*rows)))
        time = to_float(columns["Time"])
        if not np.nanmax(time) > cutoff_time:
            continue
        steps = np.diff(time)
        if len(steps) and np.nanmax(steps) > interval_bin:
            continue
        kept = time < cutoff_time
        time = time[kept]
        # pd.cut: right-closed bins (edges[i], edges[i+1]]; outside → no bin.
        ids = np.searchsorted(edges, time, side="left")
        labels = np.where((ids == 0) | (ids == len(edges)) | np.isnan(time), -1, ids - 1)
        values = np.stack([to_float(columns[f])[kept] for f in features], axis=1)
        if filename in binned:
            raise ValueError(f"Index contains duplicate entries: {filename}")
        binned[filename] = group_mean(labels, values, num_timesteps)

    names = sorted(binned)
    # pivot(index=filename, columns=bin, values=features): features in the
    # given order, bins ascending.
    x = np.stack([binned[n].T.reshape(-1) for n in names]).astype(np.float32)
    x = x.reshape(x.shape[0], -1, num_timesteps).transpose(0, 2, 1)
    save_split(data_dir / subdataset, x, train_frac, random_seed)


# ----------------------------------------------------------------- US droughts
def droughts_preprocess(
    data_dir: Path,
    random_seed: int,
    train_frac: float = 0.9,
    start_date: str = "2011-01-01",
    end_date: str = "2012-01-01",
) -> None:
    """One year of daily county meteorology → ``(N, 365, F)``
    (``fdtpu/data/preprocessing.py:264-282``).  Rows outside the year are
    skipped as they are read."""
    start, end = np.datetime64(start_date, "s"), np.datetime64(end_date, "s")
    path = data_dir / "train_timeseries" / "train_timeseries.csv"
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        i_date = header.index("date")
        seen: dict[str, bool] = {}
        rows = []
        for row in reader:
            if not row:
                continue
            day = row[i_date]
            inside = seen.get(day)
            if inside is None:
                stamp = np.datetime64(day, "s")
                inside = seen[day] = bool(start <= stamp < end)
            if inside:
                rows.append(row)
    columns = dict(zip(header, zip(*rows)))
    values = {h: to_float(columns[h]) for h in header if h not in ("fips", "date")}
    # dropna(axis=1) over the year's rows.
    names = [h for h, v in values.items() if not np.isnan(v).any()]
    fips = np.array([int(v) for v in columns["fips"]], np.int64)
    x, _ = pivot_mean(fips, to_datetime(columns["date"]),
                      np.stack([values[h] for h in names], axis=1), names)
    num_days = int((end - start) // np.timedelta64(1, "D"))
    x = x.astype(np.float32)
    x = x.reshape(x.shape[0], -1, num_days).transpose(0, 2, 1)
    save_split(data_dir, x, train_frac, random_seed)

