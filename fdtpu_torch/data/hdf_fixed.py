"""Reader for pandas' *fixed-format* HDF5 frames, without pandas (port of
``fdtpu/data/hdf_fixed.py:41-108``).

MIMIC-Extract ships ``all_hourly_data.h5`` as frames that ``DataFrame.to_hdf``
wrote in pandas' default fixed format.  This reads that layout with ``h5py``
into a :class:`Table`: the row index's levels as per-row arrays, the column
labels, and one array per column.  The layout, per frame at group ``/<key>``:

* group attrs: ``pandas_type=b"frame"``, ``nblocks``, ``axis{0,1}_variety``
  ∈ {``regular``, ``multi``} (+ ``..._nlevels``);
* ``axis0`` holds the columns, ``axis1`` the index; a regular axis is one
  dataset with ``kind``/``name`` attrs, a multi axis is ``{key}_level{i}``
  (the level's values) and ``{key}_label{i}`` (the codes) per level;
* per dtype block ``i``: ``block{i}_items`` (an axis over the block's
  columns) and ``block{i}_values``, stored ``(n_items, n_rows)`` under
  ``transposed=True``;
* strings are fixed-width UTF-8 ``S`` bytes.

``h5py`` is imported when a file is read: a machine without it (the GPU
machine has none) prepares MIMIC's ``.npy`` tensors on another machine.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Any, Hashable

import numpy as np

__all__ = ["Table", "read_fixed_frame"]


@dataclasses.dataclass
class Table:
    """A frame as arrays.  ``index`` maps each row-index level's name to its
    per-row values; ``columns`` holds the column labels (tuples under a
    column MultiIndex) and ``column_names`` their level names; ``data`` one
    array per column, in ``columns``' order."""

    index: dict[str, np.ndarray]
    columns: list[Hashable]
    column_names: list[Any]
    data: list[np.ndarray]

    def column(self, label: Hashable) -> np.ndarray:
        return self.data[self.columns.index(label)]


def _dec(value: Any) -> Any:
    """An h5py attribute value: bytes → str; pytables stores Python objects
    such as a ``None`` index name as pickle bytes, which are unpickled."""
    if isinstance(value, np.generic):
        value = value.item()
    if isinstance(value, bytes):
        if value.startswith(b"\x80"):  # pickle protocol ≥ 2 opcode
            try:
                return pickle.loads(value)
            except (pickle.UnpicklingError, EOFError, AttributeError, ImportError):
                return None
        return value.decode("utf-8")
    return value


def _decode_strings(values: np.ndarray) -> np.ndarray:
    if values.dtype.kind == "S":
        return np.char.decode(values, "utf-8").astype(object)
    return values


def _read_dataset(group: Any, key: str) -> tuple[np.ndarray, dict]:
    ds = group[key]
    return _decode_strings(ds[()]), dict(ds.attrs)


def _read_axis(group: Any, key: str) -> tuple[list[np.ndarray], list[Any]]:
    """An axis as one per-position array a level, and the level names."""
    variety = _dec(group.attrs.get(f"{key}_variety", b"regular"))
    if variety == "multi":
        levels, names = [], []
        for i in range(int(group.attrs[f"{key}_nlevels"])):
            level, attrs = _read_dataset(group, f"{key}_level{i}")
            codes = _read_dataset(group, f"{key}_label{i}")[0]
            names.append(_dec(attrs.get("name")))
            levels.append(level[codes])
        return levels, names
    values, attrs = _read_dataset(group, key)
    name = _dec(attrs.get("name"))
    return [values], [name if isinstance(name, str) else None]


def _labels(levels: list[np.ndarray]) -> list[Hashable]:
    """Axis labels: tuples under a MultiIndex, plain values otherwise."""
    if len(levels) == 1:
        return levels[0].tolist()
    return list(zip(*(level.tolist() for level in levels)))


def read_fixed_frame(path: Path | str, key: str) -> Table:
    """Read the fixed-format frame at ``path`` group ``key``."""
    try:
        import h5py
    except ImportError as exc:
        raise RuntimeError(
            f"Reading {path} needs h5py, which is not installed here. Run the MIMIC "
            "preprocessing (fdtpu_torch.data.preprocessing.mimic_preprocess) on a machine "
            "that has h5py and copy its X_train.npy and X_test.npy into the dataset "
            "directory."
        ) from exc

    with h5py.File(path, "r") as f:
        group = f[key]
        pandas_type = _dec(group.attrs.get("pandas_type", b""))
        if pandas_type != "frame":
            raise ValueError(
                f"{path}:{key} is pandas_type={pandas_type!r}, expected a "
                "fixed-format 'frame' (table-format frames need pytables)"
            )
        column_levels, column_names = _read_axis(group, "axis0")
        index_levels, index_names = _read_axis(group, "axis1")
        by_label: dict[Hashable, np.ndarray] = {}
        for i in range(int(group.attrs["nblocks"])):
            items = _labels(_read_axis(group, f"block{i}_items")[0])
            values, attrs = _read_dataset(group, f"block{i}_values")
            if not attrs.get("transposed", False):
                values = values.T
            by_label.update(zip(items, values))
    columns = _labels(column_levels)
    index = {(name if name is not None else f"level_{i}"): np.asarray(level)
             for i, (name, level) in enumerate(zip(index_names, index_levels))}
    return Table(index=index, columns=columns, column_names=column_names,
                 data=[by_label[label] for label in columns])
