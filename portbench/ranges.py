"""Device time of the kernels launched inside named host ranges of a
profiled segment (the program's ``fdtpu.dit.*`` profiler ranges).

While CUDA activity is profiled, each host range that launches kernels also
appears on the device's timeline as a user annotation of the same name,
from the start of its first kernel to the end of its last (the profiler
ties them through CUPTI's external correlation).  A device operation counts
toward the named annotation that holds its midpoint, or toward ``None``
where none does.  (The host operators' ``kernels`` are no base for this:
the profiler also hangs kernels on CUDA runtime calls whose correlation ids
collide with the operators', which counts a kernel twice.)"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Iterable, Optional


def _is_device(e) -> bool:
    return "cuda" in str(getattr(e, "device_type", "")).lower()


def device_seconds(prof, names: Iterable[str]) -> dict[Optional[str], float]:
    """``{range name or None: device seconds}`` of the device operations in
    the profiler ``prof``'s trace; the ranges are those named ``names``."""
    names = set(names)
    device = [e for e in prof.events() if _is_device(e)]
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in device
                   if getattr(e, "is_user_annotation", False) and e.name in names)
    starts = [s[0] for s in spans]
    out: dict[Optional[str], float] = defaultdict(float)
    for e in device:
        if getattr(e, "is_user_annotation", False):
            continue
        mid = 0.5 * (e.time_range.start + e.time_range.end)
        i = bisect.bisect_right(starts, mid) - 1
        owner = spans[i][2] if i >= 0 and mid <= spans[i][1] else None
        out[owner] += (e.time_range.end - e.time_range.start) * 1e-6
    return dict(out)


def range_pct(obs: dict, name: str) -> Optional[float]:
    """Range ``name``'s device seconds in the traced segment (the entry's
    ``traced["ranges"]``) over the segment's busy time, in %; None where the
    run sorted no kernel into a range."""
    trace, found = obs.get("trace"), (obs.get("traced") or {}).get("ranges")
    if not trace or not found or trace["busy_s"] <= 0.0:
        return None
    return 100.0 * found.get(name, 0.0) / trace["busy_s"]
