"""Reading the profiler's trace of a traced segment: device time by kernel,
the device's busy time over the segment, and its longest idle gaps labelled
by what the host was doing (the benchmark's ``portbench.*`` ranges and the
innermost operator the host was in)."""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable

import torch

WINDOW = "portbench.window"


@contextmanager
def phase(name: str):
    """A host range of the benchmark, ``portbench.<name>``."""
    with torch.profiler.record_function(f"portbench.{name}"):
        yield


def _is_device(e) -> bool:
    return "cuda" in str(getattr(e, "device_type", "")).lower()


def activities(device) -> list:
    """Host and (on a card) device activity."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


def profile(fn: Callable[[], None], device):
    """Run ``fn`` under the profiler inside the ``portbench.window`` range;
    returns the profiler."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    with torch.profiler.profile(activities=activities(device)) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            sync()
    return prof


def summarize(prof, top: int = 10) -> dict:
    """``kernels`` {name: [count, seconds, first start, last end]} (the
    times in seconds from the window's start), ``busy_s`` and ``window_s`` (the
    union of device activity inside the window range, and the range's
    length), ``device_ops`` and ``idle_gaps`` (the ``top`` of each, as
    [name, seconds]).  The window is the ``portbench.window`` range."""
    events = list(prof.events())
    host = [e for e in events if not _is_device(e)]
    window = [e for e in host if e.name == WINDOW]
    if not window:
        raise RuntimeError("the trace has no portbench.window range")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    kernels: dict[str, list] = {}
    spans = []
    for e in events:
        if not _is_device(e) or getattr(e, "is_user_annotation", False):
            continue
        if e.name.startswith("portbench."):
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        entry = kernels.setdefault(e.name, [0, 0.0, math.inf, -math.inf])
        entry[0] += 1
        entry[1] += (e.time_range.end - e.time_range.start) * 1e-6
        entry[2] = min(entry[2], (e.time_range.start - w0) * 1e-6)
        entry[3] = max(entry[3], (e.time_range.end - w0) * 1e-6)
        if b > a:
            spans.append((a, b))
    spans.sort()
    busy, gaps, cursor = 0.0, [], w0
    for a, b in spans:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if w1 > cursor:
        gaps.append((cursor, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = [[_label(host, (a + b) / 2), (b - a) * 1e-6] for a, b in gaps[:top]]
    ops = sorted(([k, v[1]] for k, v in kernels.items()), key=lambda kv: -kv[1])[:top]
    return dict(kernels=kernels, busy_s=busy * 1e-6, window_s=(w1 - w0) * 1e-6,
                device_ops=[[name[:160], s] for name, s in ops], idle_gaps=labelled)


def _label(host, at: float) -> str:
    """The innermost benchmark range and the innermost host operator around
    the instant ``at``."""
    inside = [e for e in host if e.time_range.start <= at <= e.time_range.end]
    ours = [e for e in inside if e.name.startswith("portbench.")]
    theirs = [e for e in inside if not e.name.startswith("portbench.")]

    def innermost(es):
        return min(es, key=lambda e: e.time_range.end - e.time_range.start).name if es else None

    phase_name = innermost(ours).removeprefix("portbench.")
    op = innermost(theirs)
    return phase_name if op is None else f"{phase_name}: {op[:100]}"


def count(kernels: dict, fragment: str) -> tuple[int, float]:
    """Launches and device seconds of the kernels whose name holds ``fragment``."""
    n, s = 0, 0.0
    for name, (c, sec, *_) in kernels.items():
        if fragment in name:
            n += c
            s += sec
    return n, s
