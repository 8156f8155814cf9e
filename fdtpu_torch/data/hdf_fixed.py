"""Reader and writer for pandas' *fixed-format* HDF5 frames, without pandas
(port of ``fdtpu/data/hdf_fixed.py``).

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

``h5py`` is imported when a file is read or written: a machine without it
(the GPU machine has none) prepares MIMIC's ``.npy`` tensors on another
machine.  :func:`write_fixed_frame` writes a :class:`Table` in that layout
(a MultiIndex axis's levels sorted, as pandas builds them), which both
packages' readers read as they read pandas' own files.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Any, Hashable

import numpy as np

__all__ = ["Table", "read_fixed_frame", "write_fixed_frame"]


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


def _h5py(path: Path | str):
    try:
        import h5py
    except ImportError as exc:
        raise RuntimeError(
            f"Reading or writing {path} needs h5py, which is not installed here. Run the MIMIC "
            "preprocessing (fdtpu_torch.data.preprocessing.mimic_preprocess) on a machine "
            "that has h5py and copy its X_train.npy and X_test.npy into the dataset "
            "directory."
        ) from exc
    return h5py


def read_fixed_frame(path: Path | str, key: str) -> Table:
    """Read the fixed-format frame at ``path`` group ``key``."""
    with _h5py(path).File(path, "r") as f:
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


def _encode(values: np.ndarray) -> np.ndarray:
    if values.dtype.kind in "OU":
        return np.char.encode(values.astype(str), "utf-8")
    return values


def _kind(values: np.ndarray) -> np.bytes_:
    return np.bytes_("string" if values.dtype.kind in "OSU" else "integer")


def _write_axis(group: Any, key: str, levels: list[np.ndarray], names: list[Any],
                rows: Any = slice(None)) -> None:
    """An axis of one array a level (per position) and its level names; a
    MultiIndex (several levels) stores each level's sorted values and the
    codes of the positions ``rows`` selects."""
    if len(levels) > 1:
        group.attrs[f"{key}_variety"] = np.bytes_("multi")
        group.attrs[f"{key}_nlevels"] = len(levels)
        for i, (level, name) in enumerate(zip(levels, names)):
            values, codes = np.unique(level, return_inverse=True)
            ds = group.create_dataset(f"{key}_level{i}", data=_encode(values))
            ds.attrs["kind"] = _kind(values)
            if name is not None:
                ds.attrs["name"] = np.bytes_(str(name))
            group.create_dataset(f"{key}_label{i}", data=codes.reshape(-1)[rows])
        return
    group.attrs[f"{key}_variety"] = np.bytes_("regular")
    values = levels[0][rows]
    ds = group.create_dataset(key, data=_encode(values))
    ds.attrs["kind"] = _kind(values)
    if names[0] is not None:
        ds.attrs["name"] = np.bytes_(str(names[0]))


def write_fixed_frame(table: Table, path: Path | str, key: str, mode: str = "a") -> None:
    """Write ``table`` to ``path`` group ``key`` in pandas' fixed format:
    one block a dtype, in the order the columns first show it."""
    h5py = _h5py(path)
    tuples = bool(table.columns) and isinstance(table.columns[0], tuple)
    labels = ([np.array([c[i] for c in table.columns]) for i in range(len(table.columns[0]))]
              if tuples else [np.array(table.columns)])
    with h5py.File(path, mode) as f:
        if key in f:
            del f[key]
        group = f.create_group(key)
        for name, value in (("pandas_type", "frame"), ("pandas_version", "0.15.2"),
                            ("encoding", "UTF-8"), ("errors", "strict")):
            group.attrs[name] = np.bytes_(value)
        group.attrs["ndim"] = 2
        _write_axis(group, "axis0", labels, table.column_names)
        _write_axis(group, "axis1", [np.asarray(v) for v in table.index.values()],
                    list(table.index))
        by_dtype: dict[np.dtype, list[int]] = {}
        for pos, values in enumerate(table.data):
            by_dtype.setdefault(np.asarray(values).dtype, []).append(pos)
        group.attrs["nblocks"] = len(by_dtype)
        for i, (dtype, locs) in enumerate(by_dtype.items()):
            _write_axis(group, f"block{i}_items", labels, table.column_names, np.array(locs))
            values = np.stack([np.asarray(table.data[j], dtype) for j in locs])
            group.create_dataset(f"block{i}_values", data=_encode(values)).attrs[
                "transposed"] = True
