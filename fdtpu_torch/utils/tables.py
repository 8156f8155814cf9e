"""Tables of result rows without pandas.

:func:`write_csv` writes what ``pandas.DataFrame(rows).to_csv(path,
index=False)`` writes for rows of numbers, strings, booleans and missing
values: the columns are the union of the rows' keys in first-seen order; a
column of integers with a missing value is a float column (``100.0``); a
float is written as numpy's shortest repr; a missing value, or a NaN, is an
empty field.

:class:`Grid` is a labelled table, a frame with a row index, and the
functions below are the frame operations the viz code takes from pandas
(3.x), each written to give pandas' result bit for bit:

* :func:`pivot_table` — ``pd.pivot_table`` with the groups and the columns
  sorted, a group whose aggregate is NaN left out and then a column NaN in
  every row (``dropna=True``); ``"mean"`` is pandas' Kahan ``group_mean``
  (:func:`kahan_mean`), :func:`sem` is ``x.std() / len(x) ** 0.5`` through
  ``nanops.nanvar``;
* :func:`groupby_mean_std` — ``groupby(keys)[cols].agg(["mean", "std"])``:
  the std is ``group_var``'s Welford update, ddof 1, NaN below two values;
* :func:`concat_blocks` — ``pd.concat(grids, keys=..., axis=1)``;
* :func:`float_text` — ``Series.astype(str)`` of a float: the shortest
  repr (``1e-05``), a NaN kept missing (pandas 3's string dtype);
* :func:`write_grid_csv` — ``frame.to_csv(path)`` with the index and a
  column header of several levels;
* :func:`grid_latex` — ``frame.to_latex(escape=False)``: ``\\multirow`` and
  ``\\cline`` under a two-level index, ``{:.6f}`` floats, ``NaN`` cells.

``DataFrame.round(3)`` is ``np.round(values, 3)`` (half to even on the
binary value).
"""

from __future__ import annotations

import csv
import dataclasses
import math
from pathlib import Path
from typing import Any, Callable, Hashable, Optional

import numpy as np

from fdtpu_torch.data.preprocessing import group_mean


def _missing(v: Any) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _column(values: list) -> list[str]:
    """One column's fields, as pandas infers the column's dtype."""
    values = [v.item() if isinstance(v, np.generic) else v for v in values]
    present = [v for v in values if not _missing(v)]
    complete = len(present) == len(values)
    numbers = bool(present) and all(
        isinstance(v, (int, float)) and not isinstance(v, bool) for v in present)
    if numbers and complete and all(isinstance(v, int) for v in present):
        return [str(v) for v in values]
    if numbers:
        text = np.array([np.nan if _missing(v) else float(v) for v in values]).astype(str)
        return ["" if _missing(v) else s for v, s in zip(values, text.tolist())]
    return ["" if _missing(v) else str(v) for v in values]


def column_names(rows: list[dict[str, Any]]) -> list[str]:
    """A frame's columns from its rows: the keys in first-seen order."""
    return list(dict.fromkeys(k for row in rows for k in row))


def write_csv(rows: list[dict[str, Any]], path: Path | str) -> None:
    columns = column_names(rows)
    fields = [_column([row.get(c) for row in rows]) for c in columns]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(zip(*fields))


def float_text(x: Any) -> Optional[str]:
    """``astype(str)`` of one float: its shortest repr; None for a NaN."""
    return None if _missing(x) else repr(float(x))


def series_mean(values: np.ndarray) -> float:
    """``Series.mean()`` (``nanops.nanmean``): the NaN-skipping sum, in the
    values' dtype, over the count."""
    ok = ~np.isnan(values)
    return float(np.where(ok, values, 0).sum() / ok.sum())


def kahan_mean(values: np.ndarray) -> float:
    """pandas' group mean of one group: a Kahan sum over the non-NaN values
    in order, over their count (NaN for none)."""
    values = np.asarray(values, np.float64)
    return float(group_mean(np.zeros(len(values), np.int64), values[:, None], 1)[0, 0])


def sem(values: np.ndarray) -> float:
    """``x.std() / len(x) ** 0.5``: ``nanops.nanvar``'s two passes (a NaN
    skipped, ddof 1), over the group's length, NaNs counted."""
    values = np.asarray(values, np.float64)
    ok = ~np.isnan(values)
    count = int(ok.sum())
    if count <= 1:
        return math.nan
    kept = np.where(ok, values, 0.0)
    avg = kept.sum(dtype=np.float64) / count
    sqr = np.where(ok, (avg - kept) ** 2, 0.0)
    return math.sqrt(sqr.sum(dtype=np.float64) / (count - 1)) / len(values) ** 0.5


def _welford_std(values: np.ndarray) -> float:
    """``group_var``'s std of one group: Welford's update over the non-NaN
    values in order, ddof 1."""
    nobs, mean, ssq = 0, 0.0, 0.0
    for v in values:
        if math.isnan(v):
            continue
        nobs += 1
        old = mean
        mean += (v - old) / nobs
        ssq += (v - mean) * (v - old)
    return math.sqrt(ssq / (nobs - 1)) if nobs > 1 else math.nan


@dataclasses.dataclass
class Grid:
    """A frame with a row index: ``rows`` holds each row's index labels (a
    tuple, one label a level of ``index_names``), ``columns`` each column's
    labels (a tuple, one a level of ``column_names``), ``values`` the cells,
    ``(len(rows), len(columns))``: float64 (a missing cell NaN) or object
    (text, a missing cell None)."""

    index_names: list[Optional[str]]
    rows: list[tuple]
    column_names: list[Optional[str]]
    columns: list[tuple]
    values: np.ndarray

    def block(self, key: Hashable) -> "Grid":
        """``frame[key]``: the columns under the top-level label ``key``."""
        keep = [j for j, c in enumerate(self.columns) if c[0] == key]
        return Grid(self.index_names, self.rows, self.column_names[1:],
                    [self.columns[j][1:] for j in keep], self.values[:, keep])


def _grouped(records: list[dict[str, Any]], keys: list[str]) -> dict[tuple, list[dict]]:
    """Records by their keys' values, sorted; a record missing a key is left
    out (``groupby(dropna=True)``)."""
    groups: dict[tuple, list[dict]] = {}
    for r in records:
        key = tuple(r.get(k) for k in keys)
        if not any(_missing(k) for k in key):
            groups.setdefault(key, []).append(r)
    return dict(sorted(groups.items()))


def _values(group: list[dict], name: str) -> np.ndarray:
    return np.array([math.nan if _missing(r.get(name)) else r[name] for r in group], np.float64)


def pivot_table(records: list[dict[str, Any]], index: list[str], column: str, value: str,
                aggfunc: Callable[[np.ndarray], float]) -> Grid:
    """``pd.pivot_table(frame, index=index, columns=column, values=value,
    aggfunc=...)`` over row dicts; ``aggfunc`` takes a group's values in row
    order (float64, NaN where missing)."""
    agg = {}
    for key, group in _grouped(records, [*index, column]).items():
        v = float(aggfunc(_values(group, value)))
        if not math.isnan(v):
            agg[key] = v
    rows = sorted({k[:-1] for k in agg})
    cols = sorted({k[-1] for k in agg})
    values = np.full((len(rows), len(cols)), np.nan)
    for key, v in agg.items():
        values[rows.index(key[:-1]), cols.index(key[-1])] = v
    return Grid(list(index), rows, [column], [(c,) for c in cols], values)


def groupby_mean_std(records: list[dict[str, Any]], keys: list[str],
                     names: list[str]) -> tuple[list[tuple], np.ndarray, np.ndarray]:
    """The sorted group keys and each group's ``(mean, std)`` of each of
    ``names``: two ``(groups, len(names))`` arrays."""
    groups = _grouped(records, keys)
    means = np.array([[kahan_mean(_values(g, n)) for n in names] for g in groups.values()])
    stds = np.array([[_welford_std(_values(g, n)) for n in names] for g in groups.values()])
    shape = (len(groups), len(names))
    return list(groups), means.reshape(shape), stds.reshape(shape)


def concat_blocks(grids: list[Grid], keys: list[Hashable]) -> Grid:
    """``pd.concat(grids, keys=keys, axis=1)``: the grids side by side under
    a new top column level; the rows are the first grid's, then those only
    a later one holds, in its order."""
    rows = list(grids[0].rows)
    for g in grids[1:]:
        rows += [r for r in g.rows if r not in rows]
    columns, blocks = [], []
    for key, g in zip(keys, grids):
        columns += [(key, *c) for c in g.columns]
        block = np.full((len(rows), len(g.columns)), np.nan)
        for i, r in enumerate(g.rows):
            block[rows.index(r)] = g.values[i]
        blocks.append(block)
    return Grid(grids[0].index_names, rows, [None, *grids[0].column_names], columns,
                np.concatenate(blocks, axis=1))


def _cell_text(v: Any) -> str:
    if isinstance(v, (float, np.floating)):
        return float_text(v) or ""
    return "" if v is None else str(v)


def write_grid_csv(grid: Grid, path: Path | str) -> None:
    """``frame.to_csv(path)``: a header line a column level (the level's
    name, blanks under the other index levels, the labels), the index
    names' line, then a line a row (its labels, its cells)."""
    pad = [""] * (len(grid.index_names) - 1)
    header = [[name or "", *pad, *(str(c[level]) for c in grid.columns)]
              for level, name in enumerate(grid.column_names)]
    header.append([name or "" for name in grid.index_names] + [""] * len(grid.columns))
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerows(header)
        for row, cells in zip(grid.rows, grid.values):
            writer.writerow([*map(str, row), *map(_cell_text, cells)])


def grid_latex(grid: Grid) -> str:
    """``frame.to_latex(escape=False)`` of a grid with one column level: the
    columns ``r`` and floats ``{:.6f}`` in a float grid, ``l`` and text in
    an object one, a missing cell ``NaN``; under a two-level index the
    first level's label spans its rows (``\\multirow[t]``) and a
    ``\\cline`` closes each of its groups."""
    if len(grid.column_names) != 1:
        raise ValueError("grid_latex writes a grid with one column level")
    numeric = grid.values.dtype.kind == "f"
    width = len(grid.index_names) + len(grid.columns)

    def cell(v: Any) -> str:
        if v is None or (numeric and math.isnan(v)):
            return "NaN"
        return f"{v:.6f}" if numeric else str(v)

    def line(cells: list[str]) -> str:
        return " & ".join(cells) + " \\\\"

    lines = ["\\begin{tabular}{" + "l" * len(grid.index_names)
             + ("r" if numeric else "l") * len(grid.columns) + "}", "\\toprule",
             line([""] * (len(grid.index_names) - 1) + [grid.column_names[0] or ""]
                  + [str(c[0]) for c in grid.columns])]
    if any(name is not None for name in grid.index_names):
        lines.append(line([name or "" for name in grid.index_names] + [""] * len(grid.columns)))
    lines.append("\\midrule")
    body = [[str(label) for label in row] + [cell(v) for v in cells]
            for row, cells in zip(grid.rows, grid.values)]
    if len(grid.index_names) == 1:
        lines += [line(cells) for cells in body]
    else:
        i = 0
        while i < len(body):
            n = sum(1 for row in grid.rows[i:] if row[0] == grid.rows[i][0])
            for k in range(n):
                cells = list(body[i + k])
                cells[0] = "" if k else (f"\\multirow[t]{{{n}}}{{*}}{{{cells[0]}}}"
                                         if n > 1 else cells[0])
                lines.append(line(cells))
            lines.append(f"\\cline{{1-{width}}}")
            i += n
    lines += ["\\bottomrule", "\\end{tabular}", ""]
    return "\n".join(lines)
