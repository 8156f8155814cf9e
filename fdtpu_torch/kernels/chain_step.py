"""The E²-CRF score level's reverse step as three hand-written CUDA kernels
(``csrc/chain_step.cu``) and their launch counts.

Replaces no TPU kernel.  The JAX package's score-level step is jnp code that
XLA fuses inside ``lax.scan`` / ``lax.cond``; the port's resident chain
(:class:`~fdtpu_torch.sampling.resident.Chain`) captured the same PyTorch
ops node by node, 82 kernel nodes a skipped step, whose time is the nodes'
latency and not their bytes (the source's header).  On a card the chain at
the score level with the Taylor predictor runs each segment as one kernel:

    score_pre(clock, mode, sem, modes, drift_rate, err_acc, tau_0, overrun, R, auto_calibrate)
        the step's decision (``score_skip_decision``) and what ``Chain._set_mode``
        writes: ``sem`` (1 refresh, 0 skip), ``mode`` (the branch: ``sem · (1 + cold)``),
        ``modes[i]`` and the branch's run count in ``clock``
    score_skip(clock, ts, G, eps_hat, eps_prev, eps_prev2, eps_gap, eps_gap2, drift_rate,
               err_acc, score, order, scheduler)
        the skip branch (``sampler._skip`` with ``eps_predict``): ``score`` = the
        Taylor prediction of ε̂ over the marginal std, ``err_acc += drift_rate``
    score_post(clock, sem, ts, step_size, G, score, noise, x, done, scheduler, max_len)
        the Euler–Maruyama update of ``x`` (``SDE.step``), the counters
        (``count_mode``), ``step + 1`` and ``i + 1``

each in place on the chain's static tensors: ``clock`` the chain's int64
vector ``[i, step, last_full_step, cold, recompute_count, cache_hit_count,
full_steps, mixed_steps, cached_steps, runs of branch 0, …]``, ``mode``,
``sem``, ``drift_rate``, ``err_acc``, ``tau_0``, ``overrun``, ``eps_gap`` and
``eps_gap2`` 0-d tensors, the ε̂ history, ``score``, ``x`` (B, T, C), ``G``
(T,) the noise scaling, ``ts`` the time grid and ``step_size`` 0-d.  The step
reads ``ts[i]`` and, from a (steps, B, T, C) ``noise``, ``noise[i]`` (or a
(B, T, C) ``noise`` as it is).  ``done`` is a 0-d int32 tensor at 0, the
post kernel's count of finished blocks, put back to 0 by the last.  The
kernels take float32 (the ε̂ history, ``x``, the score) and int64 (the clock,
the modes), contiguous, on one card; they round as the chain's PyTorch
segments do, operation by operation.  Those segments are the kernels' plain
versions: the chain runs them wherever the kernels do not engage (the CPU
among others), and the card tests hold each kernel to its segment bitwise.
A CPU tensor is an error here: there is no fallback.
``launches_pre``, ``launches_skip`` and ``launches_post`` count the kernels'
launches, a graph's replays through :mod:`fdtpu_torch.utils.graphs`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from fdtpu_torch.diffusion.sde import SDE, VEScheduler, VPScheduler
from fdtpu_torch.kernels import build

SOURCE = "chain_step"
# The clock's entries (``resident.RUNS`` is the first branch's run count).
I, STEP, LAST_FULL, COLD, RECOMPUTE, HITS, FULL, MIXED, CACHED, RUNS = range(10)
_VP, _VE = 0, 1

launches_pre = 0
launches_skip = 0
launches_post = 0
_lib: Optional[ctypes.CDLL] = None


def _f32(value: float) -> float:
    """A Python scalar as PyTorch casts it into a float32 operation."""
    return float(torch.tensor(value, dtype=torch.float32))


def _kind(scheduler: SDE) -> int:
    if isinstance(scheduler, VPScheduler):
        return _VP
    if isinstance(scheduler, VEScheduler):
        return _VE
    raise TypeError(f"the chain's step kernels take VP or VE, got {type(scheduler).__name__}")


def std_coefficients(scheduler: SDE) -> tuple[int, float, float]:
    """The marginal std's scalars: VP ``beta_min``, ``beta_max − beta_min``;
    VE ``sigma_min``, ``sigma_max / sigma_min``."""
    kind = _kind(scheduler)
    if kind == _VP:
        return kind, _f32(scheduler.beta_min), _f32(scheduler.beta_max - scheduler.beta_min)
    return kind, _f32(scheduler.sigma_min), _f32(scheduler.sigma_max / scheduler.sigma_min)


def step_coefficients(scheduler: SDE) -> tuple[int, float, float]:
    """The update's scalars: VP as :func:`std_coefficients`; VE
    ``sigma_min · √(2 log ratio)``, ``ratio = sigma_max / sigma_min``."""
    kind = _kind(scheduler)
    if kind == _VP:
        return std_coefficients(scheduler)
    ratio = scheduler.sigma_max / scheduler.sigma_min
    return kind, _f32(scheduler.sigma_min * math.sqrt(2.0 * math.log(ratio))), _f32(ratio)


# ------------------------------------------------------------------ kernels
def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.fdtpu_chain_score_pre.argtypes = [vp] * 8 + [i32, i64, vp]
        lib.fdtpu_chain_score_skip.argtypes = [vp] * 11 + [i32, i32, f32, f32, i32, i32, i32, vp]
        lib.fdtpu_chain_score_post.argtypes = [vp] * 7 + [i64, vp, vp, i32, f32, f32, i32, i32,
                                                          i32, i64, vp]
        for name in ("pre", "skip", "post"):
            getattr(lib, f"fdtpu_chain_score_{name}").restype = ctypes.c_int
        _lib = lib
    return _lib


def _device(name: str, clock: torch.Tensor) -> torch.device:
    if clock.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on a CUDA device, the clock is on "
                         f"{clock.device} (the chain's PyTorch segments run there)")
    return clock.device


def _check(name: str, device: torch.device, dtype: torch.dtype, **tensors) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, the clock on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_rows(name: str, x: torch.Tensor, G: torch.Tensor, **rows) -> None:
    if x.ndim != 3 or G.shape != (x.shape[1],):
        raise ValueError(f"{name}: need (B, T, C) and G (T,), got {tuple(x.shape)} and "
                         f"{tuple(G.shape)}")
    for arg, t in rows.items():
        if t.shape != x.shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} is not {tuple(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError(f"{name}: the kernel takes fewer than 2^31 elements, got {x.numel()}")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"chain_step {name} kernel launch failed: cudaError_t {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def score_pre(clock, mode, sem, modes, drift_rate, err_acc, tau_0, overrun, R: int,
              auto_calibrate: bool) -> None:
    """The step's decision, in place (module docstring)."""
    global launches_pre
    dev = _device("score_pre", clock)
    _check("score_pre", dev, torch.int64, clock=clock, mode=mode, sem=sem, modes=modes)
    _check("score_pre", dev, torch.float32, drift_rate=drift_rate, err_acc=err_acc,
           tau_0=tau_0, overrun=overrun)
    if clock.shape[0] <= RUNS + 2:
        raise ValueError(f"score_pre: the clock holds the three branches' runs, got "
                         f"{clock.shape[0]} entries")
    _launched("score_pre", _library().fdtpu_chain_score_pre(
        clock.data_ptr(), mode.data_ptr(), sem.data_ptr(), modes.data_ptr(),
        drift_rate.data_ptr(), err_acc.data_ptr(), tau_0.data_ptr(), overrun.data_ptr(),
        int(auto_calibrate), int(R), _stream(dev)))
    launches_pre += 1


def score_skip(clock, ts, G, eps_hat, eps_prev, eps_prev2, eps_gap, eps_gap2, drift_rate,
               err_acc, score, order: int, scheduler: SDE) -> None:
    """The skip branch, in place (module docstring)."""
    global launches_skip
    dev = _device("score_skip", clock)
    if order not in (0, 1, 2):
        raise ValueError(f"score_skip: eps_order is 0, 1 or 2, got {order}")
    _check("score_skip", dev, torch.int64, clock=clock)
    _check("score_skip", dev, torch.float32, ts=ts, G=G, eps_hat=eps_hat, eps_prev=eps_prev,
           eps_prev2=eps_prev2, eps_gap=eps_gap, eps_gap2=eps_gap2, drift_rate=drift_rate,
           err_acc=err_acc, score=score)
    _check_rows("score_skip", score, G, eps_hat=eps_hat, eps_prev=eps_prev, eps_prev2=eps_prev2)
    kind, a, b = std_coefficients(scheduler)
    n, seq, channels = score.numel(), score.shape[1], score.shape[2]
    _launched("score_skip", _library().fdtpu_chain_score_skip(
        clock.data_ptr(), ts.data_ptr(), G.data_ptr(), eps_hat.data_ptr(), eps_prev.data_ptr(),
        eps_prev2.data_ptr(), eps_gap.data_ptr(), eps_gap2.data_ptr(), drift_rate.data_ptr(),
        err_acc.data_ptr(), score.data_ptr(), order, kind, a, b, n, seq, channels, _stream(dev)))
    launches_skip += 1


def score_post(clock, sem, ts, step_size, G, score, noise, x, done, scheduler: SDE,
               max_len: int) -> None:
    """The update of ``x`` and the counters, in place (module docstring)."""
    global launches_post
    dev = _device("score_post", clock)
    _check("score_post", dev, torch.int64, clock=clock, sem=sem)
    _check("score_post", dev, torch.float32, ts=ts, step_size=step_size, G=G, score=score,
           noise=noise, x=x)
    _check("score_post", dev, torch.int32, done=done)
    _check_rows("score_post", x, G, score=score)
    if noise.shape not in (x.shape, (ts.shape[0], *x.shape)):
        raise ValueError(f"score_post: noise {tuple(noise.shape)} is neither x's "
                         f"{tuple(x.shape)} nor one such a step")
    noise_step = x.numel() if noise.ndim == x.ndim + 1 else 0
    kind, a, b = step_coefficients(scheduler)
    _launched("score_post", _library().fdtpu_chain_score_post(
        clock.data_ptr(), sem.data_ptr(), ts.data_ptr(), step_size.data_ptr(), G.data_ptr(),
        score.data_ptr(), noise.data_ptr(), noise_step, x.data_ptr(), done.data_ptr(), kind, a,
        b, x.numel(), x.shape[1], x.shape[2], int(max_len), _stream(dev)))
    launches_post += 1
