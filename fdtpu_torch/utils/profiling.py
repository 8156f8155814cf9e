"""The port's spans and counters, and its profiler trace.

* :func:`span` marks a region of host code that runs on every call (a
  sampler's call, a trajectory's replay, a training epoch, a checkpoint).
  Spans nest: each records its name, an id, its parent (the innermost open
  span), the call it belongs to (every span under one root, such as
  ``fdtpu.sample`` or ``fdtpu.fit``, shares the root's call id) and its host
  start and end (``time.perf_counter_ns``).  ``device=True`` also records a
  CUDA event on the current stream at the span's start and end: the device
  interval of the work the span enqueued.  :func:`count` adds to a named
  counter at the same boundaries.
* :func:`recording` turns recording on for the enclosed region;
  :func:`export` returns what the newest recording holds as plain dicts.
  Off is the default: then :func:`span` returns a shared no-op context after
  one check, and :func:`count` returns at once.
* While ``torch.profiler`` runs, each span also opens
  ``torch.profiler.record_function(name)``, so the program's spans sit on
  the profiler's clock beside the device trace (recording on or off).
* :func:`trace` records the enclosed region with ``torch.profiler`` and
  writes a Chrome trace; :func:`block_until_ready` waits for a result's
  devices.
* The cache's counters are in the sampler's ``get_cache_stats()``.

One clock.  At :func:`recording`'s entry the device is synchronised and a
base event recorded, and the host time taken: a device interval is exported
on the host's ``perf_counter_ns`` clock as that host time plus the event's
elapsed time from the base.  The recorder never synchronises on its own while
recording: events are read where the program already waits for the device
(:func:`settle`, non-blocking, reads the events the device has passed: at a
chain's read and a root span's end) and at the recording's end, which
synchronises once.  No event is recorded while the
current stream is capturing a graph (a graph replays no host code), and
no span belongs inside a function that a graph captures.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Iterator, Optional

import torch

_profiler_enabled = torch.autograd._profiler_enabled


class Recorder:
    """The spans, counters and pending device events of one recording."""

    def __init__(self, cuda: bool) -> None:
        self.spans: list[dict[str, Any]] = []
        self.counters: dict[str, int] = defaultdict(int)
        self.stack: list[tuple[dict[str, Any], Any]] = []
        self.pending: list[tuple[dict[str, Any], Any, Any]] = []
        self.free: list[Any] = []  # events read back, for reuse
        self.calls = 0
        self.base = None
        if cuda:
            torch.cuda.synchronize()
            self.base = torch.cuda.Event(enable_timing=True)
            self.base.record()
        self.base_ns = time.perf_counter_ns()

    def _event(self):
        """A recorded event on the current stream, or None where none may be
        recorded (no card, or the stream is capturing)."""
        if self.base is None or torch.cuda.is_current_stream_capturing():
            return None
        event = self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def open(self, name: str, device: bool, attrs: dict[str, Any]) -> None:
        parent = self.stack[-1][0] if self.stack else None
        if parent is None:
            self.calls += 1
        record = {"name": name, "id": len(self.spans),
                  "parent": None if parent is None else parent["id"],
                  "call": self.calls - 1 if parent is None else parent["call"],
                  "start_ns": time.perf_counter_ns(), "end_ns": None,
                  "device_start_ns": None, "device_end_ns": None, "attrs": attrs}
        self.spans.append(record)
        self.stack.append((record, self._event() if device else None))

    def close(self) -> None:
        record, start = self.stack.pop()
        if start is not None:
            end = self._event()
            if end is None:
                self.free.append(start)
            else:
                self.pending.append((record, start, end))
        record["end_ns"] = time.perf_counter_ns()
        if not self.stack:
            self.settle()

    def settle(self, wait: bool = False) -> None:
        """Read the device intervals whose end event the device has passed
        (``wait``: all of them, after a synchronise)."""
        if wait and self.pending:
            torch.cuda.synchronize()
        waiting = []
        for record, start, end in self.pending:
            if not (wait or end.query()):
                waiting.append((record, start, end))
                continue
            record["device_start_ns"] = self.base_ns + round(self.base.elapsed_time(start) * 1e6)
            record["device_end_ns"] = self.base_ns + round(self.base.elapsed_time(end) * 1e6)
            self.free += [start, end]
        self.pending = waiting

    def export(self) -> dict[str, Any]:
        covered: dict[int, int] = defaultdict(int)
        for s in self.spans:
            if s["parent"] is not None and s["end_ns"] is not None:
                covered[s["parent"]] += s["end_ns"] - s["start_ns"]
        spans = []
        for s in self.spans:
            out = dict(s, attrs=dict(s["attrs"]))
            out["self_ns"] = (None if s["end_ns"] is None
                              else s["end_ns"] - s["start_ns"] - covered[s["id"]])
            spans.append(out)
        return {"spans": spans, "counters": dict(self.counters)}


_recorder: Optional[Recorder] = None  # the open recording
_last: Optional[Recorder] = None  # the newest recording, open or closed


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "device", "attrs", "range", "recorder")

    def __init__(self, name: str, device: bool, attrs: dict[str, Any]) -> None:
        self.name, self.device, self.attrs = name, device, attrs
        self.range = self.recorder = None

    def __enter__(self) -> None:
        if _profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.recorder = _recorder
        if self.recorder is not None:
            self.recorder.open(self.name, self.device, self.attrs)

    def __exit__(self, *exc) -> bool:
        if self.recorder is not None:
            self.recorder.close()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, device: bool = False, **attrs: Any):
    """A context manager marking a region of host code (module docstring);
    ``device``: the region enqueues work on the current CUDA stream, whose
    device interval to record."""
    if _recorder is None and not _profiler_enabled():
        return NO_SPAN
    return _Span(name, device, attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of the open recording, if any."""
    if _recorder is not None:
        _recorder.counters[name] += int(n)


def settle() -> None:
    """Read the device intervals the device has already passed, without
    waiting (call it where the program has just read from the device)."""
    if _recorder is not None:
        _recorder.settle()


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record spans and counters in the enclosed region (module docstring)."""
    global _recorder, _last
    if _recorder is not None:
        raise RuntimeError("a recording is already open")
    _recorder = _last = Recorder(torch.cuda.is_available())
    try:
        yield _recorder
    finally:
        _recorder = None
        _last.settle(wait=_last.base is not None)


def export() -> dict[str, Any]:
    """The newest recording's ``{"spans": [...], "counters": {...}}``.  A
    span: ``name``, ``id``, ``parent`` (an id, None for a root), ``call``
    (the root's call number), ``start_ns`` / ``end_ns`` (host), ``self_ns``
    (its host time less its children's), ``device_start_ns`` /
    ``device_end_ns`` (None without device events) and ``attrs``; spans in
    the order they opened."""
    return {"spans": [], "counters": {}} if _last is None else _last.export()


@contextlib.contextmanager
def trace(log_dir: Path | str = "fdtpu_trace") -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region, the program's spans among the host's
    ranges; writes ``<log_dir>/trace.json``, which ``chrome://tracing`` and
    Perfetto open.  Do not profile a resident chain (a sampler with
    ``batches_per_call`` > 1 on a card): an illegal memory access has been
    seen twice with the profiler on a chain of conditional graph nodes, and
    is not explained (ROADMAP A.1); CUPTI also misses kernels inside those
    nodes."""
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
