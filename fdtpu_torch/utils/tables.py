"""CSV tables of result rows without pandas.

:func:`write_csv` writes what ``pandas.DataFrame(rows).to_csv(path,
index=False)`` writes for rows of numbers, strings, booleans and missing
values: the columns are the union of the rows' keys in first-seen order; a
column of integers with a missing value is a float column (``100.0``); a
float is written as numpy's shortest repr; a missing value, or a NaN, is an
empty field.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Any

import numpy as np


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


def write_csv(rows: list[dict[str, Any]], path: Path | str) -> None:
    columns: list[str] = []
    for row in rows:
        columns += [k for k in row if k not in columns]
    fields = [_column([row.get(c) for row in rows]) for c in columns]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(zip(*fields))
