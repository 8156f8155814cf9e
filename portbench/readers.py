"""Arithmetic the per-layer readers (``metrics/<metric>.py``) share: each
takes what a run observed, ``obs``, and returns its number or None when the
run has nothing to read for it."""

from __future__ import annotations

from typing import Optional

from portbench.flops.attention import attention_bound_s, attention_bwd_bound_s
from portbench.trace import count

BOUNDS = {"b1": attention_bound_s, "b2": attention_bwd_bound_s}
KERNELS = {"b1": "blockdiag_mha_fwd_kernel", "b2": "blockdiag_mha_bwd_kernel"}


def roofline_pct(obs: dict, kernel: str) -> Optional[float]:
    """The kernel's least time (its bound at each launch's shape) over its
    device time in the traced segment, in %."""
    trace = obs.get("trace")
    shapes = (obs.get("traced") or {}).get("shapes", {}).get(kernel)
    if not trace or not shapes:
        return None
    n, seconds = count(trace["kernels"], KERNELS[kernel])
    if n == 0 or seconds <= 0.0:
        return None
    least = sum(BOUNDS[kernel](b, t, h, dh)[0] * launches for b, t, h, dh, launches in shapes)
    return 100.0 * least / seconds


def idle_pct(obs: dict) -> Optional[float]:
    """The traced window's share in which no device operation ran, in %."""
    trace = obs.get("trace")
    if not trace or trace["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def extent(obs: dict, kernel: str) -> Optional[tuple[float, float]]:
    """The start of the kernel's first launch and the end of its last in the
    traced segment, in seconds from the segment's start."""
    trace = obs.get("trace")
    found = [v for k, v in (trace or {}).get("kernels", {}).items() if KERNELS[kernel] in k]
    if not found:
        return None
    return min(v[2] for v in found), max(v[3] for v in found)
