"""What every cell of the benchmark shares: the manifest and the cell's
files, seeds, the checks on the environment, and the result line."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Optional

T0 = time.perf_counter()
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"
# Top-level module names that may not be loaded in a run: the JAX stack and
# the JAX package that the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fdtpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file, a trace
    that missed a launch): the run exits non-zero and prints no result."""


def stamp(label: str) -> None:
    """A line on standard error: ``label`` and the seconds since start."""
    print(f"portbench: {time.perf_counter() - T0:8.3f} s {label}", file=sys.stderr, flush=True)


def sub_seed(seed: int, *tags: Any) -> int:
    """A 63-bit seed derived from the run's ``seed`` and ``tags``; any
    whole number is a valid ``seed``."""
    text = ":".join([str(int(seed)), *map(str, tags)])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    if not MANIFEST.exists():
        raise BenchError(f"{MANIFEST} is missing")
    return load_json(MANIFEST)


def cell_files(name: str, bench: Optional[dict] = None) -> tuple[dict, dict, dict]:
    """The manifest's entry of cell ``name``, its traffic file
    ``workloads/<name>.json`` and its configuration file."""
    bench = manifest() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    traffic = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    config = load_json(ROOT / configs[cell["config"]]["file"])
    return cell, traffic, config


def metrics_of(cell_name: str, section: str, bench: Optional[dict] = None) -> list[dict]:
    """The manifest's metrics of ``section`` (``end_to_end`` or
    ``per_layer``) that cell ``cell_name`` reports."""
    bench = manifest() if bench is None else bench
    return [m for m in bench[section] if cell_name in m.get("workloads", [cell_name])]


def load_reader(metric: str) -> ModuleType:
    """The reader of a per-layer metric: ``metrics/<metric>.py``, or, where
    there is none, ``metrics/<base>.py`` for the name's part before its
    first dot (``mfu.uncached`` is read by ``mfu.py``)."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    if not path.exists():
        path = BENCH_DIR / "metrics" / f"{metric.split('.', 1)[0]}.py"
    if not path.exists():
        raise BenchError(f"no reader {path} for the per-layer metric {metric!r}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own kernels build into ``build/fdtpu_torch_kernels``)."""
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN_MODULES` (``fdtpu_torch`` is not ``fdtpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def check_numbers(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number is
    finite and at most its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        ok = ok and math.isfinite(value) and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def print_result(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                 checks: dict, breakdown: Optional[dict] = None) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output (``checks`` its last key)."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    print(json.dumps(line), flush=True)
