"""Tracing and timing (port of ``fdtpu/utils/profiling.py``).

* :func:`trace` records the enclosed region with ``torch.profiler`` (the
  host and, on a card, the device) and writes a Chrome trace;
* :class:`WallClock` accumulates named wall-clock sections, waiting for the
  device that holds a section's result before it stops the clock, so that
  asynchronous CUDA work is counted where it was launched;
* the cache's counters are in the sampler's ``get_cache_stats()``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Path | str = "fdtpu_trace") -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region; writes ``<log_dir>/trace.json``, which
    ``chrome://tracing`` and Perfetto open."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def block_until_ready(result: Any) -> Any:
    """Wait for every CUDA device holding a tensor of ``result`` (a tensor,
    or lists, tuples and dicts of them); return ``result``."""
    devices = set()

    def visit(x: Any) -> None:
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)

    visit(result)
    for device in devices:
        torch.cuda.synchronize(device)
    return result


class WallClock:
    """Accumulating named timers."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, result: Optional[Any] = None) -> Iterator[None]:
        """Time the enclosed block, waiting for ``result``'s devices at its end."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            block_until_ready(result)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def time_fn(self, name: str, fn, *args, **kwargs):
        """Call ``fn`` and time it up to its result being ready."""
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kwargs))
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(1, self.counts[name]),
            }
            for name in self.totals
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
