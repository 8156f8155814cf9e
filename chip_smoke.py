#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fdtpu_torch``) on one NVIDIA GPU and check it.

Usage, from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; builds the CUDA kernels from ``fdtpu_torch/kernels/csrc``, one
   ``nvcc`` per source, in parallel.
2. Kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the main path's shapes (B1 at the serving batch, B2 at the
   training batch, B4 at the token level's rows against all keys, at the
   KV level's square shape and past 5000 keys), with its time (and B4's
   device time from the profiler), the plain version's time, a
   one-call PyTorch yardstick (``library_ms``, timed only) and the least time
   the card could take (``bound_ms``); then B3, the autograd Function over B1
   and B2, against autograd through the plain forward, and its device time;
   B1's and B2's float32 and B4's float32 and bfloat16 times at head_dim
   4..32 (which pipe binds).
3. Slice: the flagship score model (d_model 72, 10 layers, 12 heads, FFN
   2048, 187 frequency tokens; random weights from a seed) on CUDA with the
   block-diagonal attention kernel: ``score_apply`` against the einsum path
   and against the CPU; then ``DiffusionSampler`` uncached and at the
   score-level E²-CRF operating point, T = 1000 steps, 256 samples in
   batches of 128; kernel launches counted on each chain; samples
   de-standardized with the synthetic train-set statistics and taken back to
   the time domain.
4. Token and KV levels: a 50-step token-level chain on CUDA against the CPU
   (the same noise and probe uniforms; the same mode at every step); the
   token level at ``cli/ablation_cache.py``'s ``token_full`` arm (256
   samples, batches of 128) and the KV level's event arm (``kv_event_arm(10)``)
   and macro policy (``cli/benchmark_cache.py``) on one batch of 128, T = 1000
   steps each, with B1 counted once per layer and FULL step and B4 once per
   layer and TOPK, MIXED or CACHED step; the cost of the K/V store's
   transposed copy after a blockdiag refresh; where a 200-step token-level
   and KV-event window's time goes.
5. Training: one training step's parameter gradients on the kernel path
   against the einsum path; then ``Trainer.fit`` of the flagship for 2
   epochs (2000 synthetic samples, batch 64: 32 train and 32 val batches an
   epoch) with finite, falling loss and the kernel launches counted (B2 once
   per layer and train step, B1 once per layer and train or val forward);
   train samples/s, ms/step and where a step's device time goes.
6. FreqCa and FreSca: 50-step chains on CUDA against the CPU (the same noise
   and probe uniforms; the same mode at every step; the same FreqCa ring) of
   the score level with the FreqCa predictor, the score level with FreSca
   (energy cutoff) and the KV event policy with FreqCa's CRF ring; the same
   three chains at T = 1000 on one batch of 128 with B1 and B4 counted; where
   a FreSca call's and a FreqCa skip step's time goes.
7. Evaluation, on the network phase 5 trained: ``calibrate_tau_0`` (256 pilot
   samples, T = 1000, batches of 128, the score level's operating point
   without τ₀), then 256 samples uncached and 256 at the operating point,
   taken back to the data domain and scored with ``MetricCollection``
   (sliced Wasserstein over 1000 directions and marginal Wasserstein, time
   and frequency domain, spectral density, self-split and dummy baselines)
   against the datamodule's train set.  Quality is printed, not gated; B1's
   launches are counted.

Float32 matmuls run in full float32 (TF32 off for matmuls and cuDNN).  The
line before the last is one JSON object with a record per kernel (its head
case's times, and every case's under "cases"); the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM published peaks (dense): CUDA-core float32, bf16 tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# The score-level E²-CRF operating point served by bench.py (CACHE_KWARGS).
CACHE_KWARGS = {"level": "score", "R": 100, "tau_0": 1.35, "eps_order": 1}
# The token level's "token_full" arm (cli/ablation_cache.py:60); the KV
# level's calibrated event arm kv_event_arm(10.0) (cli/ablation_cache.py:80-87)
# and its macro policy (cli/benchmark_cache.py:153).
TOKEN_KWARGS = {"level": "token", "token_budget": 24, "tau_0": 0.5, "R": 100}
KV_EVENT_KWARGS = {"level": "kv", "policy": "event", "K": 0, "R": 100, "tau_0": 10.0,
                   "tau_warn": 1e9}
KV_MACRO_KWARGS = {"level": "kv", "policy": "macro", "K": 5, "R": 10}
FLAGSHIP = dict(batch=128, seq=187, n_head=12, head_dim=6)
# bench.py's training protocol: 2000 synthetic samples in batches of 64.
TRAIN_FLAGSHIP = dict(batch=64, seq=187, n_head=12, head_dim=6)
TRAIN_SAMPLES = 2000
TRAIN_EPOCHS = 2
NUM_STEPS = 1000
NUM_SAMPLES = 256
SAMPLE_BATCH = 128
# The sampler's FreqCa and FreSca options on the flagship's operating points.
FREQ_CHAINS = {
    "score-freqca": (dict(CACHE_KWARGS, eps_predictor="freqca"), {}),
    "score-fresca": (CACHE_KWARGS, {"use_fresca": True, "fresca_cutoff_strategy": "energy"}),
    "kv-event-freqca": (dict(KV_EVENT_KWARGS, use_freqca=True), {}),
}
# configs/metrics/default.yaml with cli/sample.py's random_seed.
METRICS_SEED = 42
SW_DIRECTIONS = 1000
# B4 in bfloat16 against the plain version of the same bfloat16 inputs: the
# limit past rtol 2^-7, four times the largest reading on the H100 (1.95e-3,
# PERF.md §6).
MHA_SAME_ATOL = 8e-3


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_err(a, b) -> float:
    """Largest difference relative to the reference's largest magnitude."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound_ms(batch, seq, n_head, head_dim, itemsize, bf16,
                       kv_len=None) -> tuple[float, str]:
    """Least time for one attention call (blockdiag_mha, fused_mha) of
    ``seq`` query rows against ``kv_len`` keys (default ``seq``): q, k, v
    read once and out written once, against 4·B·H·Tq·Tk·Dh score/value FLOPs
    at the input type's peak plus B·H·Tq·Tk float32 exps at the float32
    peak."""
    kv_len = seq if kv_len is None else kv_len
    n_bytes = 2 * batch * (seq + kv_len) * n_head * head_dim * itemsize
    flops = 4 * batch * n_head * seq * kv_len * head_dim
    exps = batch * n_head * seq * kv_len
    t_bytes = n_bytes / PEAK_HBM_BYTES
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS) + exps / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def attention_bwd_bound_ms(batch, seq, n_head, head_dim, itemsize, bf16) -> tuple[float, str]:
    """Least time for one blockdiag_mha_bwd call: q, k, v, g read once and
    dq, dk, dv written once, against the five products' 10·B·H·T²·Dh FLOPs
    at the input type's peak plus B·H·T² float32 exps at the float32 peak."""
    n_bytes = 7 * batch * seq * n_head * head_dim * itemsize
    flops = 10 * batch * n_head * seq * seq * head_dim
    exps = batch * n_head * seq * seq
    t_bytes = n_bytes / PEAK_HBM_BYTES
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS) + exps / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def kernel_phase(torch, bda) -> list[dict]:
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def inputs(batch, seq, n_head, head_dim, kind="randn"):
        d = n_head * head_dim
        v = randn(batch, n_head, seq, head_dim)
        if kind == "randn":
            return randn(batch, seq, d), randn(batch, n_head, head_dim, seq), v
        a = {"negative": 3.0, "underflow": 50.0}[kind]
        return (torch.full((batch, seq, d), a, device="cuda"),
                torch.full((batch, n_head, head_dim, seq), -a, device="cuda"), v)

    flag = tuple(FLAGSHIP.values())
    cases = [
        ("flagship_f32", flag, "randn", torch.float32, True, 2e-4),
        ("flagship_bf16", flag, "randn", torch.bfloat16, True, 5e-2),
        ("t501_f32", (16, 501, 12, 6), "randn", torch.float32, True, 2e-4),
        ("flagship_noshift_f32", flag, "randn", torch.float32, False, 2e-4),
        ("flagship_negative_f32", flag, "negative", torch.float32, True, 2e-4),
        ("flagship_underflow_f32", flag, "underflow", torch.float32, True, 2e-4),
    ]
    results = []
    for name, shape, kind, dtype, shift, tol in cases:
        q32, k32, v32 = inputs(*shape, kind)
        q, k, v = (a.to(dtype).contiguous() for a in (q32, k32, v32))
        out = bda.blockdiag_mha_cuda(q, k, v, shift)
        torch.cuda.synchronize()
        # bf16 is held against the float32 plain version of the unrounded inputs.
        ref = bda.blockdiag_mha_plain(q32, k32, v32, shift)
        err = float((out.float() - ref).abs().max())
        check(bool(torch.isfinite(out).all()), f"{name}: kernel output not finite")
        check(err <= tol, f"{name}: max_abs_err {err:.3g} > {tol}")
        b, t, h, dh = shape
        qh = q.view(b, t, h, dh).transpose(1, 2)
        kh = k.transpose(2, 3)
        kernel_ms = time_ms(torch, lambda: bda.blockdiag_mha_cuda(q, k, v, shift))
        plain_ms = time_ms(torch, lambda: bda.blockdiag_mha_plain(q, k, v, shift))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, v))
        bound_ms, bound_by = attention_bound_ms(b, t, h, dh, q.element_size(),
                                                dtype == torch.bfloat16)
        rec = dict(case=name, shape=list(shape), dtype=str(dtype).split(".")[-1], shift=shift,
                   max_abs_err=err, tol=tol, kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        print("kernel", json.dumps(rec), flush=True)
        results.append(rec)
    return results


@functools.lru_cache(maxsize=None)
def max_sm_clock_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])


def mufu_floor_ms(torch, exps: int) -> float:
    """Least time for ``exps`` float32 exps on the card's special-function
    units: 16 a clock an SM (H100) at the card's top SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * exps / (16 * sms * max_sm_clock_mhz() * 1e6)


def device_ms(torch, fn, kernel: str, reps: int = 20) -> float:
    """Mean device time a call of the CUDA kernels whose name holds
    ``kernel`` (torch.profiler), without the host's launch cost."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if kernel in e.key:
            total += getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    return total / 1e3 / reps


def mha_kernel_phase(torch, mha) -> list[dict]:
    """B4 against its plain version at the token level's TOPK shape (24 rows
    against 187 keys), the KV level's square shape, T = 501 and Tk = 5000 (past
    the earlier kernel's shared-memory limit); bfloat16 against the plain
    version both of the same bfloat16 inputs and of the unrounded float32 ones."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(12)
    b, t, h, dh = FLAGSHIP.values()
    # Tolerances: float32 sums in another order than the plain version's
    # einsums, exp2 of pre-scaled scores: 2e-4, B1's bound.  bfloat16 against
    # the float32 plain version of the unrounded inputs (8-bit rounding of
    # values of magnitude ~3): 5e-2.  bfloat16 against the plain version of the
    # same bfloat16 inputs: both round the output's float32 sum to bf16, and
    # sums in another order may round one bf16 ulp apart: rtol 2^-7.  Both also
    # round the weights to bf16 from float32 values a few float32 ulps apart
    # (exp2 against exp, a reciprocal against a division), so now and then a
    # weight w rounds one bf16 ulp apart and moves its output by ~2^-8 w |v|:
    # atol MHA_SAME_ATOL, four times the largest such reading on the H100.
    cases = [("topk", (b, 24, t)), ("square", (b, t, t)), ("t501", (16, 501, 501)),
             ("tk5000", (4, t, 5000))]
    results = []
    for name, (batch, tq, tk) in cases:
        q32 = torch.randn((batch, tq, h, dh), generator=g, device="cuda")
        k32 = torch.randn((batch, tk, h, dh), generator=g, device="cuda")
        v32 = torch.randn((batch, tk, h, dh), generator=g, device="cuda")
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 5e-2)):
            q, k, v = (a.to(dtype) for a in (q32, k32, v32))
            out = mha.fused_mha_cuda(q, k, v)
            torch.cuda.synchronize()
            err = float((out.float() - mha.mha_plain(q32, k32, v32)).abs().max())
            label = f"{name}_{str(dtype).split('.')[-1]}"
            check(bool(torch.isfinite(out).all()), f"{label}: B4 output not finite")
            check(err <= tol, f"{label}: B4 max_abs_err {err:.3g} > {tol}")
            same = {}
            if dtype == torch.bfloat16:
                ref = mha.mha_plain(q, k, v).float()
                excess = float(((out.float() - ref).abs() - 2 ** -7 * ref.abs()).max())
                same = dict(same_input_err=float((out.float() - ref).abs().max()),
                            same_input_excess=excess, same_input_atol=MHA_SAME_ATOL,
                            same_input_rtol=2 ** -7)
                check(excess <= MHA_SAME_ATOL, f"{label}: B4 against the plain version of "
                      f"the same bf16 inputs exceeds rtol 2^-7 by {excess:.3g} > atol "
                      f"{MHA_SAME_ATOL}")
            qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(qh, kh, vh)

            bound_ms, bound_by = attention_bound_ms(batch, tq, h, dh, q.element_size(),
                                                    dtype == torch.bfloat16, kv_len=tk)
            rec = dict(case=label, shape=[batch, tq, tk, h, dh], dtype=str(dtype).split(".")[-1],
                       max_abs_err=err, tol=tol, **same,
                       kernel_ms=time_ms(torch, lambda: mha.fused_mha_cuda(q, k, v)),
                       device_ms=device_ms(torch, lambda: mha.fused_mha_cuda(q, k, v),
                                           "fused_mha"),
                       plain_ms=time_ms(torch, lambda: mha.mha_plain(q, k, v)),
                       library_ms=time_ms(torch, library),
                       bound_ms=bound_ms, bound_by=bound_by,
                       mufu_floor_ms=mufu_floor_ms(torch, batch * h * tq * tk))
            print("kernel_mha", json.dumps(rec), flush=True)
            results.append(rec)
    return results


def bwd_kernel_phase(torch, bda) -> list[dict]:
    """B2 against its plain version: max abs error over dq, dk and dv."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(10)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def inputs(batch, seq, n_head, head_dim, kind="randn"):
        d = n_head * head_dim
        v, grad = randn(batch, n_head, seq, head_dim), randn(batch, seq, d)
        if kind == "randn":
            return randn(batch, seq, d), randn(batch, n_head, head_dim, seq), v, grad
        return (torch.full((batch, seq, d), 3.0, device="cuda"),
                torch.full((batch, n_head, head_dim, seq), -3.0, device="cuda"), v, grad)

    flag = tuple(TRAIN_FLAGSHIP.values())
    # Tolerances: float32 sums in another order than the plain version's
    # einsums, over T = 187..501 keys: 2e-4, the forward's bound.  bfloat16
    # inputs against the float32 plain version of the unrounded inputs: the
    # inputs and dS, W round to 8 bits (relative 2^-8 on gradients of
    # magnitude ~3), so 5e-2, the forward's bf16 bound.
    cases = [
        ("train_f32", flag, "randn", torch.float32, 2e-4),
        ("train_bf16", flag, "randn", torch.bfloat16, 5e-2),
        ("t501_f32", (16, 501, 12, 6), "randn", torch.float32, 2e-4),
        ("train_negative_f32", flag, "negative", torch.float32, 2e-4),
    ]
    results = []
    for name, shape, kind, dtype, tol in cases:
        full = inputs(*shape, kind)
        args = [a.to(dtype).contiguous() for a in full]
        got = bda.blockdiag_mha_bwd_cuda(*args)
        torch.cuda.synchronize()
        ref = bda.blockdiag_mha_bwd_plain(*full)
        err = max(float((a.float() - r).abs().max()) for a, r in zip(got, ref))
        check(all(bool(torch.isfinite(a).all()) for a in got), f"{name}: B2 output not finite")
        check(err <= tol, f"{name}: B2 max_abs_err {err:.3g} > {tol}")
        b, t, h, dh = shape
        q, k, v, grad = args
        qh = q.view(b, t, h, dh).transpose(1, 2).detach().requires_grad_()
        kh = k.transpose(2, 3).detach().requires_grad_()
        vh = v.detach().requires_grad_()
        out = F.scaled_dot_product_attention(qh, kh, vh)
        gh = grad.view(b, t, h, dh).transpose(1, 2)
        kernel_ms = time_ms(torch, lambda: bda.blockdiag_mha_bwd_cuda(*args))
        plain_ms = time_ms(torch, lambda: bda.blockdiag_mha_bwd_plain(*args))
        library_ms = time_ms(torch, lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                                retain_graph=True))
        bound_ms, bound_by = attention_bwd_bound_ms(b, t, h, dh, q.element_size(),
                                                    dtype == torch.bfloat16)
        rec = dict(case=name, shape=list(shape), dtype=str(dtype).split(".")[-1],
                   max_abs_err=err, tol=tol, kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        print("kernel_bwd", json.dumps(rec), flush=True)
        results.append(rec)
    return results


def trainable_phase(torch, bda) -> dict:
    """B3: the Function's gradients against autograd through the plain
    forward, at the training shape, and the time of forward + backward."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(11)
    b, t, h, dh = TRAIN_FLAGSHIP.values()
    q = torch.randn((b, t, h * dh), generator=g, device="cuda").requires_grad_()
    k = torch.randn((b, h, dh, t), generator=g, device="cuda").requires_grad_()
    v = torch.randn((b, h, t, dh), generator=g, device="cuda").requires_grad_()
    grad = torch.randn((b, t, h * dh), generator=g, device="cuda")

    def through(fn):
        return torch.autograd.grad(fn(q, k, v), (q, k, v), grad)

    got = through(bda.blockdiag_mha_trainable)
    want = through(bda.blockdiag_mha_plain)
    err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    # Tolerance: two float32 gradients of the same function, summed in other
    # orders: 2e-4, the kernels' own bound.
    check(err <= 2e-4, f"blockdiag_mha_trainable gradient max_abs_err {err:.3g} > 2e-4")
    qh, kh = q.view(b, t, h, dh).transpose(1, 2), k.transpose(2, 3)
    gh = grad.view(b, t, h, dh).transpose(1, 2)
    fwd_bound, _ = attention_bound_ms(b, t, h, dh, 4, False)
    bwd_bound, _ = attention_bwd_bound_ms(b, t, h, dh, 4, False)
    rec = dict(
        shape=[b, t, h, dh], max_abs_err=err,
        ms=time_ms(torch, lambda: through(bda.blockdiag_mha_trainable)),
        plain_ms=time_ms(torch, lambda: through(bda.blockdiag_mha_plain)),
        library_ms=time_ms(torch, lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qh, kh, v), (q, k, v), gh)),
        bound_ms=fwd_bound + bwd_bound, bound_by="operations",
    )
    print("trainable", json.dumps(rec), flush=True)
    # Where B3's time goes beyond B1 + B2: device time by kernel against the wall.
    device_breakdown(torch, "trainable", lambda: through(bda.blockdiag_mha_trainable),
                     reps=20, top=6, no_grad=False)
    return rec


def head_dim_sweep(torch, bda, mha) -> None:
    """Which pipe binds B1, B2 and B4: times at the main path's B, T, H and
    head_dim 4..32 (B1, B2 in float32; B4 at the square shape in float32 and
    bfloat16).  The exps stay B·H·T² while the multiply-adds grow with
    head_dim, so a time that follows head_dim is the FMA (or tensor) pipe's."""
    g = torch.Generator(device="cuda").manual_seed(13)
    for dh in (4, 6, 8, 16, 32):
        for name, (b, t, h, _) in (("blockdiag_mha", FLAGSHIP.values()),
                                   ("blockdiag_mha_bwd", TRAIN_FLAGSHIP.values())):
            q = torch.randn((b, t, h * dh), generator=g, device="cuda")
            k = torch.randn((b, h, dh, t), generator=g, device="cuda")
            v = torch.randn((b, h, t, dh), generator=g, device="cuda")
            if name == "blockdiag_mha":
                ms = time_ms(torch, lambda: bda.blockdiag_mha_cuda(q, k, v))
            else:
                ms = time_ms(torch, lambda: bda.blockdiag_mha_bwd_cuda(q, k, v, q))
            print("kernel_sweep", json.dumps({"kernel": name, "shape": [b, t, h, dh],
                                              "dtype": "float32", "ms": ms}), flush=True)
        b, t, h, _ = FLAGSHIP.values()
        q, k, v = (torch.randn((b, t, h, dh), generator=g, device="cuda") for _ in range(3))
        for dtype in (torch.float32, torch.bfloat16):
            args = [a.to(dtype) for a in (q, k, v)]
            ms = time_ms(torch, lambda: mha.fused_mha_cuda(*args))
            print("kernel_sweep", json.dumps({"kernel": "fused_mha", "shape": [b, t, t, h, dh],
                                              "dtype": str(dtype).split(".")[-1], "ms": ms}),
                  flush=True)


def device_breakdown(torch, label: str, fn, reps: int = 3, top: int = 8,
                     no_grad: bool = True) -> None:
    """Device time of ``fn`` by kernel (torch.profiler) and the share of its
    wall time (measured under the profiler) that the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with torch.set_grad_enabled(not no_grad):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        # A record_function range (e.g. Optimizer.step) shows on the device
        # too, over kernels that have rows of their own: count those once.
        if getattr(e, "is_user_annotation", False):
            continue
        if dev_us > 0 and "cuda" in str(getattr(e, "device_type", "")).lower():
            rows.append((dev_us / 1e3 / reps, e.count // reps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f"breakdown {label}: wall {wall_ms:.4f} ms, the profiler saw no device time")
        return
    launched = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel") // reps
    print(f"breakdown {label}: wall {wall_ms:.4f} ms, device busy {busy:.4f} ms "
          f"({100 * busy / wall_ms:.1f}%), {launched} cudaLaunchKernel calls", flush=True)
    for ms, count, name in rows[:top]:
        print(f"breakdown {label}: {ms:9.4f} ms {100 * ms / busy:5.1f}% x{count:<5d} "
              f"{name[:90]}", flush=True)


def slice_phase(torch, bda) -> dict:
    from fdtpu_torch.data import SyntheticDatamodule
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model, score_apply
    from fdtpu_torch.ops import idft
    from fdtpu_torch.sampling import DiffusionSampler, sample_chain

    cfg = ScoreModelConfig(n_channels=1, max_len=FLAGSHIP["seq"], attention_impl="blockdiag")
    net = init_score_model(cfg, torch.Generator().manual_seed(0))
    net_einsum = init_score_model(dataclasses.replace(cfg, attention_impl="einsum"),
                                  torch.Generator().manual_seed(0))
    net_cpu = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    scheduler = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(cfg.max_len, "cuda")
    model = ScoreModel(config=cfg, network=net, scheduler=scheduler)
    print(f"slice: flagship {model.param_count()} parameters", flush=True)

    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((SAMPLE_BATCH, cfg.max_len, 1), generator=g, device="cuda")
    t = torch.rand((SAMPLE_BATCH,), generator=g, device="cuda") * (1 - 1e-5) + 1e-5
    with torch.no_grad():
        s_kernel = score_apply(net, x, t)
        s_einsum = score_apply(net_einsum, x, t)
        s_cpu = score_apply(net_cpu, x[:4].cpu(), t[:4].cpu())
        fwd_kernel_ms = time_ms(torch, lambda: score_apply(net, x, t), reps=10)
        fwd_einsum_ms = time_ms(torch, lambda: score_apply(net_einsum, x, t), reps=10)
    err_einsum = float((s_kernel - s_einsum).abs().max())
    err_cpu = float((s_kernel[:4].cpu() - s_cpu).abs().max())
    print(f"slice: score_apply kernel vs einsum max_abs_err {err_einsum:.3g}, "
          f"vs CPU {err_cpu:.3g}; forward ms at B={SAMPLE_BATCH}: kernel path "
          f"{fwd_kernel_ms:.4f}, einsum path {fwd_einsum_ms:.4f}", flush=True)
    check(bool(torch.isfinite(s_kernel).all()), "score_apply output not finite")
    check(err_einsum <= 1e-4, f"score_apply kernel vs einsum {err_einsum:.3g} > 1e-4")
    check(err_cpu <= 1e-4, f"score_apply CUDA vs CPU {err_cpu:.3g} > 1e-4")
    device_breakdown(torch, "forward", lambda: score_apply(net, x, t))

    # A short uncached chain, CUDA kernel path against the CPU plain path,
    # with the same injected noise: relative agreement of the samples.
    n_short, b_short = 50, 4
    z = torch.randn((n_short + 1, b_short, cfg.max_len, 1), generator=g, device="cuda").cpu()
    x0 = scheduler.prior_sampling((b_short, cfg.max_len, 1), noise=z[0].cuda())
    x_gpu, _ = sample_chain(net, scheduler, x0, num_steps=n_short, step_noise=z[1:])
    x_ref, _ = sample_chain(net_cpu, VPScheduler(fourier_noise_scaling=True), x0.cpu(),
                            num_steps=n_short, step_noise=z[1:])
    rel = rel_err(x_gpu.cpu(), x_ref)
    print(f"slice: {n_short}-step chain CUDA vs CPU max rel err {rel:.3g}", flush=True)
    check(rel <= 1e-4, f"short chain CUDA vs CPU rel err {rel:.3g} > 1e-4")

    with tempfile.TemporaryDirectory() as tmp:
        dm = SyntheticDatamodule(tmp, max_len=cfg.max_len, num_samples=1000,
                                 fourier_transform=True, standardize=True)
        dm.prepare_data()
        dm.setup()
        mean, std = dm.feature_mean_and_std

    chains = {}
    for name, use_cache in (("uncached", False), ("cached", True)):
        sampler = DiffusionSampler(model, SAMPLE_BATCH, use_cache=use_cache,
                                   cache_kwargs=CACHE_KWARGS if use_cache else None)
        gen = torch.Generator(device="cuda").manual_seed(2)
        torch.cuda.synchronize()
        bda.launches = 0
        t0 = time.perf_counter()
        samples = sampler.sample(NUM_SAMPLES, NUM_STEPS, generator=gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = bda.launches
        stats = sampler.get_cache_stats()
        forwards = stats["full_steps"] if use_cache else NUM_STEPS * (NUM_SAMPLES // SAMPLE_BATCH)
        check(tuple(samples.shape) == (NUM_SAMPLES, cfg.max_len, 1),
              f"{name}: samples shape {tuple(samples.shape)}")
        check(bool(torch.isfinite(samples).all()), f"{name}: samples not finite")
        check(launches == cfg.num_layers * forwards,
              f"{name}: {launches} kernel launches for {forwards} full forwards "
              f"x {cfg.num_layers} layers")
        data = samples.cpu().numpy() * std + mean
        series = idft(torch.from_numpy(data).float())
        check(bool(torch.isfinite(series).all()), f"{name}: de-standardized series not finite")
        chains[name] = dict(seconds=seconds, samples_per_s=NUM_SAMPLES / seconds,
                            full_forwards=forwards, launches=launches,
                            ms_per_step=1e3 * seconds / (NUM_STEPS * (NUM_SAMPLES // SAMPLE_BATCH)))
        if use_cache:
            chains[name]["cache_stats"] = stats
        print(f"chain {name}", json.dumps(chains[name]), flush=True)
    speedup = chains["cached"]["samples_per_s"] / chains["uncached"]["samples_per_s"]
    print(f"slice: cached over uncached {speedup:.3f}x (random weights)", flush=True)

    # Where a score-level chain's time goes: one batch of 200 steps, profiled.
    window = DiffusionSampler(model, SAMPLE_BATCH, use_cache=True, cache_kwargs=CACHE_KWARGS)
    device_breakdown(
        torch, "cached-chain-200-steps",
        lambda: window.sample(SAMPLE_BATCH, 200, generator=torch.Generator("cuda").manual_seed(3)),
        reps=1, top=6,
    )
    return chains


def recording(module, name: str, keep):
    """Wrap ``module.name`` so that ``keep(result)`` of each call is appended
    to the returned list; the second value undoes the wrapping."""
    orig = getattr(module, name)
    kept = []

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        kept.append(keep(out))
        return out

    setattr(module, name, wrapped)
    return kept, lambda: setattr(module, name, orig)


def levels_phase(torch, bda, mha) -> dict:
    """The token and KV levels of the E²-CRF cache at the flagship: a short
    token chain on CUDA against the CPU, the three T = 1000 chains with their
    kernel launches counted, the K/V transpose after a blockdiag refresh, and
    200-step token-level and KV-event windows' device time."""
    from fdtpu_torch.cache import E2CRFConfig
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
    from fdtpu_torch.sampling import DiffusionSampler, sample_chain
    from fdtpu_torch.sampling import sampler as psampler

    cfg = ScoreModelConfig(n_channels=1, max_len=FLAGSHIP["seq"], attention_impl="blockdiag")
    net = init_score_model(cfg, torch.Generator().manual_seed(0))
    net_cpu = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    scheduler = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(cfg.max_len, "cuda")
    model = ScoreModel(config=cfg, network=net, scheduler=scheduler)
    layers = cfg.num_layers

    # A short token-level chain, CUDA kernels against the CPU plain versions,
    # with the same noise and probe uniforms: the same mode at every step.
    g = torch.Generator(device="cuda").manual_seed(4)
    n_short, b_short = 50, 4
    z = torch.randn((n_short + 1, b_short, cfg.max_len, 1), generator=g, device="cuda").cpu()
    u = torch.rand((n_short, cfg.max_len), generator=g, device="cuda").cpu()
    x0 = scheduler.prior_sampling((b_short, cfg.max_len, 1), noise=z[0].cuda())
    runs = {}
    for dev, network, sched in (("cuda", net, scheduler),
                                ("cpu", net_cpu, VPScheduler(fourier_noise_scaling=True))):
        modes, undo_modes = recording(psampler, "token_policy", lambda out: out[0])
        rows, undo_rows = recording(psampler, "_topk_rows", lambda idx: sorted(idx.tolist()))
        try:
            x, _ = sample_chain(network, sched, x0.to(dev), cache_cfg=E2CRFConfig(**TOKEN_KWARGS),
                                num_steps=n_short, step_noise=z[1:], probe_noise=u)
        finally:
            undo_modes()
            undo_rows()
        runs[dev] = (x.cpu(), modes, rows)
    diverged = [i for i, (a, b) in enumerate(zip(runs["cuda"][1], runs["cpu"][1])) if a != b]
    rows_differ = [i for i, (a, b) in enumerate(zip(runs["cuda"][2], runs["cpu"][2])) if a != b]
    rel = rel_err(runs["cuda"][0], runs["cpu"][0])
    modes = "".join(map(str, runs["cuda"][1]))
    print(f"levels: {n_short}-step token chain CUDA vs CPU: modes {modes}, first divergence "
          f"{diverged[:1]}, first TOPK step with other rows {rows_differ[:1]} of "
          f"{len(runs['cuda'][2])}, max rel err {rel:.3g}", flush=True)
    check(not diverged, f"token chain CUDA vs CPU: modes diverge first at step {diverged[:1]}")
    check(not rows_differ, f"token chain CUDA vs CPU: TOPK rows differ first at {rows_differ[:1]}")
    # Tolerance 5e-4, not the uncached chain's 1e-4: the VP std at the last
    # step, t = 1e-5, is sqrt(1 - exp(-1e-6)) (the JAX package's formula), so
    # a one-ulp difference between the card's and the CPU's exp is ~3% of it,
    # and the token level's last score is -eps/std (1.39e-4 measured on the
    # H100; the same chain through two CPU attention paths agrees to 7e-7).
    check(rel <= 5e-4, f"token chain CUDA vs CPU rel err {rel:.3g} > 5e-4")

    chains = {}
    for name, kwargs, num_samples in (("token", TOKEN_KWARGS, NUM_SAMPLES),
                                      ("kv-event", KV_EVENT_KWARGS, SAMPLE_BATCH),
                                      ("kv-macro", KV_MACRO_KWARGS, SAMPLE_BATCH)):
        sampler = DiffusionSampler(model, SAMPLE_BATCH, use_cache=True, cache_kwargs=kwargs)
        gen = torch.Generator(device="cuda").manual_seed(2)
        torch.cuda.synchronize()
        bda.launches = mha.launches = 0
        t0 = time.perf_counter()
        samples = sampler.sample(num_samples, NUM_STEPS, generator=gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        b1, b4 = bda.launches, mha.launches
        stats = sampler.get_cache_stats()
        steps = NUM_STEPS * (num_samples // SAMPLE_BATCH)
        check(tuple(samples.shape) == (num_samples, cfg.max_len, 1),
              f"{name}: samples shape {tuple(samples.shape)}")
        check(bool(torch.isfinite(samples).all()), f"{name}: samples not finite")
        # B4 serves TOPK (counted as mixed steps) at the token level and
        # MIXED and CACHED at the KV level; skipped token steps run nothing.
        b4_steps = stats["mixed_steps"] + (stats["cached_steps"] if name != "token" else 0)
        check(b1 == layers * stats["full_steps"],
              f"{name}: {b1} B1 launches for {stats['full_steps']} FULL steps x {layers} layers")
        check(b4 == layers * b4_steps, f"{name}: {b4} B4 launches for {b4_steps} steps x {layers}")
        check(b4 > 0, f"{name}: B4 never launched")
        chains[name] = dict(seconds=seconds, samples_per_s=num_samples / seconds,
                            ms_per_step=1e3 * seconds / steps, launches_b1=b1, launches_b4=b4,
                            full_steps=stats["full_steps"], mixed_steps=stats["mixed_steps"],
                            cached_steps=stats["cached_steps"], cache_stats=stats)
        print(f"chain {name}", json.dumps(chains[name]), flush=True)

    # The K/V store keeps (B, T, H, Dh); a blockdiag refresh computes K and V
    # in B1's layouts and copies them in transposed, once per layer.
    b, t, h, dh = FLAGSHIP.values()
    k2 = torch.randn((b, h, dh, t), device="cuda")
    v2 = torch.randn((b, h, t, dh), device="cuda")
    store = torch.empty((2, b, t, h, dh), device="cuda")

    def transpose():
        store[0].copy_(k2.permute(0, 3, 1, 2))
        store[1].copy_(v2.permute(0, 2, 1, 3))

    transpose_ms = time_ms(torch, transpose)
    print(f"levels: K/V transpose after a blockdiag refresh {transpose_ms:.4f} ms per layer, "
          f"{layers * transpose_ms:.4f} ms per FULL step", flush=True)

    for label, kwargs in (("token-chain-200-steps", TOKEN_KWARGS),
                          ("kv-event-chain-200-steps", KV_EVENT_KWARGS)):
        window = DiffusionSampler(model, SAMPLE_BATCH, use_cache=True, cache_kwargs=kwargs)
        device_breakdown(
            torch, label,
            lambda: window.sample(SAMPLE_BATCH, 200,
                                  generator=torch.Generator("cuda").manual_seed(3)),
            reps=1, top=8,
        )
    chains["transpose_ms"] = transpose_ms
    return chains


def freq_options_phase(torch, bda, mha) -> dict:
    """FreqCa and FreSca at the flagship: 50-step chains of each of
    ``FREQ_CHAINS`` on CUDA against the CPU, the same chains at T = 1000 with
    their kernel launches counted, and the device work and launches of one
    FreSca call and of one FreqCa skip step (a Taylor skip step beside it)."""
    from fdtpu_torch.cache import E2CRFConfig, init_cache_state
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
    from fdtpu_torch.ops import fresca as pfresca
    from fdtpu_torch.sampling import DiffusionSampler, sample_chain
    from fdtpu_torch.sampling import sampler as psampler

    cfg = ScoreModelConfig(n_channels=1, max_len=FLAGSHIP["seq"], attention_impl="blockdiag")
    net = init_score_model(cfg, torch.Generator().manual_seed(0))
    net_cpu = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    # The same weights through the einsum attention: a second float32 order
    # of the same sums on the CPU, whose distance from the first is the
    # spread the chains' FreqCa rings are read against.
    net_cpu_einsum = init_score_model(dataclasses.replace(cfg, attention_impl="einsum"),
                                      torch.Generator().manual_seed(0), device="cpu")
    scheduler = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(cfg.max_len, "cuda")
    model = ScoreModel(config=cfg, network=net, scheduler=scheduler)
    layers = cfg.num_layers

    g = torch.Generator(device="cuda").manual_seed(14)
    n_short, b_short = 50, 4
    z = torch.randn((n_short + 1, b_short, cfg.max_len, 1), generator=g, device="cuda").cpu()
    u = torch.rand((n_short, cfg.max_len), generator=g, device="cuda").cpu()
    x0 = scheduler.prior_sampling((b_short, cfg.max_len, 1), noise=z[0].cuda())
    for name, (kwargs, options) in FREQ_CHAINS.items():
        level = kwargs["level"]
        policy = "score_skip_decision" if level == "score" else "event_policy"
        runs = {}
        cpu_sched = VPScheduler(fourier_noise_scaling=True)
        for dev, network, sched in (("cuda", net, scheduler), ("cpu", net_cpu, cpu_sched),
                                    ("cpu-einsum", net_cpu_einsum, cpu_sched)):
            modes, undo_modes = recording(psampler, policy,
                                          lambda out: int(out) if isinstance(out, bool) else out[0])
            # The energy cutoff bin of each FreSca call (a device read a
            # step, here only).
            bins, undo_bins = recording(pfresca, "create_frequency_masks",
                                        lambda out: int(out[0].sum()) - 1)
            try:
                x, state = sample_chain(network, sched, x0.to(dev.split("-")[0]),
                                        cache_cfg=E2CRFConfig(**kwargs), num_steps=n_short,
                                        step_noise=z[1:], probe_noise=u, **options)
            finally:
                undo_modes()
                undo_bins()
            runs[dev] = (x.cpu(), modes, bins, state)
        (x_gpu, m_gpu, bins_gpu, s_gpu), (x_cpu, m_cpu, bins_cpu, s_cpu) = runs["cuda"], runs["cpu"]
        diverged = [i for i, (a, b) in enumerate(zip(m_gpu, m_cpu)) if a != b]
        bin_flips = [i for i, (a, b) in enumerate(zip(bins_gpu, bins_cpu)) if a != b]
        rel = rel_err(x_gpu, x_cpu)
        ring = {}
        if s_cpu.crf_high_hist.ndim > 1:
            k = s_cpu.crf_t_hist.shape[0]
            live = torch.arange(k) >= k - int(s_cpu.hist_len)
            newest_kept = True
            if level == "score":
                # The score level's ring holds ε̂ = -std·score.  Entries taken
                # at the last step, t = 1e-5, carry the VP std's cancellation
                # (~3% between the card's exp and the CPU's, ROADMAP.md §C):
                # they are left out, and crf_low with them when it is one.
                last = s_cpu.crf_t_hist <= scheduler.eps
                live &= ~last
                newest_kept = not bool(last[-1])

            def ring_err(other):
                errs = [rel_err(other.crf_high_hist.cpu()[live], s_cpu.crf_high_hist[live])]
                if newest_kept:
                    errs.append(rel_err(other.crf_low.cpu(), s_cpu.crf_low))
                return max(errs)

            s_einsum = runs["cpu-einsum"][3]
            ring = dict(hist_len=(int(s_gpu.hist_len), int(s_cpu.hist_len)),
                        compared=int(live.sum()), crf_low_compared=newest_kept,
                        max_rel_err=ring_err(s_gpu),
                        cpu_spread=ring_err(s_einsum),
                        crf_t_hist=float((s_gpu.crf_t_hist.cpu() - s_cpu.crf_t_hist).abs().max()))
            # Tolerance: 1e-4 relative, or four times the spread between the
            # two CPU attention orders where the chain amplifies rounding
            # more than that (mid-chain ε̂ of a random-weight network).
            ring["tol"] = max(1e-4, 4 * ring["cpu_spread"])
        # Tolerance: 1e-4 relative, as the uncached short chain (slice phase);
        # 5e-4 where the last step reused ε̂, since its score is
        # -ε̂/std(1e-5) and that std cancels (the token chain's reason).
        last_skipped = level == "score" and m_gpu[-1] == 0
        tol = 5e-4 if last_skipped else 1e-4
        line = dict(modes="".join(map(str, m_gpu)), first_divergence=diverged[:1],
                    max_rel_err=rel, tol=tol, ring=ring)
        if bins_gpu:
            line.update(cutoff_bins=sorted(set(bins_gpu)), first_bin_flip=bin_flips[:1],
                        bin_at_flip=[(bins_gpu[i], bins_cpu[i]) for i in bin_flips[:1]])
        print(f"freq: {n_short}-step {name} chain CUDA vs CPU", json.dumps(line), flush=True)
        check(len(m_gpu) == len(m_cpu) and not diverged,
              f"{name} chain CUDA vs CPU: modes diverge first at step {diverged[:1]}")
        check(not bin_flips, f"{name} chain CUDA vs CPU: the energy cutoff bin differs first at "
              f"step {bin_flips[:1]} ({line.get('bin_at_flip')})")
        check(rel <= tol, f"{name} chain CUDA vs CPU rel err {rel:.3g} > {tol}")
        if ring:
            check(ring["hist_len"][0] == ring["hist_len"][1], f"{name}: ring lengths differ")
            check(ring["compared"] >= 2, f"{name}: fewer than two ring entries to compare")
            check(ring["max_rel_err"] <= ring["tol"],
                  f"{name}: FreqCa ring CUDA vs CPU rel err above its tolerance: {ring}")
            check(ring["crf_t_hist"] <= 6e-8, f"{name}: ring timesteps differ: {ring}")

    chains = {}
    for name, (kwargs, options) in FREQ_CHAINS.items():
        sampler = DiffusionSampler(model, SAMPLE_BATCH, use_cache=True, cache_kwargs=kwargs,
                                   **options)
        gen = torch.Generator(device="cuda").manual_seed(2)
        torch.cuda.synchronize()
        bda.launches = mha.launches = 0
        t0 = time.perf_counter()
        samples = sampler.sample(SAMPLE_BATCH, NUM_STEPS, generator=gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        b1, b4 = bda.launches, mha.launches
        stats = sampler.get_cache_stats()
        check(tuple(samples.shape) == (SAMPLE_BATCH, cfg.max_len, 1),
              f"{name}: samples shape {tuple(samples.shape)}")
        check(bool(torch.isfinite(samples).all()), f"{name}: samples not finite")
        b4_steps = stats["mixed_steps"] + stats["cached_steps"] if kwargs["level"] == "kv" else 0
        check(b1 == layers * stats["full_steps"],
              f"{name}: {b1} B1 launches for {stats['full_steps']} FULL steps x {layers} layers")
        check(b4 == layers * b4_steps, f"{name}: {b4} B4 launches for {b4_steps} steps x {layers}")
        check(b1 > 0, f"{name}: B1 never launched")
        state = sampler.last_cache_state
        chains[name] = dict(seconds=seconds, samples_per_s=SAMPLE_BATCH / seconds,
                            ms_per_step=1e3 * seconds / NUM_STEPS, launches_b1=b1,
                            launches_b4=b4, full_steps=stats["full_steps"],
                            mixed_steps=stats["mixed_steps"], cached_steps=stats["cached_steps"],
                            hist_len=int(state.hist_len), cache_stats=stats)
        print(f"chain {name}", json.dumps(chains[name]), flush=True)

    # Where one FreSca call's and one skip step's time goes, at B = 128.
    b, t_len, k = SAMPLE_BATCH, cfg.max_len, 10
    gen = torch.Generator(device="cuda").manual_seed(15)
    score = torch.randn((b, t_len, 1), generator=gen, device="cuda")
    t = torch.full((), 0.5, device="cuda")
    std = torch.rand((b, t_len), generator=gen, device="cuda") + 0.5
    device_breakdown(torch, "fresca-call", lambda: pfresca.apply_fresca_to_score(
        score, 1.0, 1.5, 0.5, "energy", timestep=t, num_steps=NUM_STEPS), reps=50, top=6)
    for label, predictor in (("freqca-skip-step", "freqca"), ("taylor-skip-step", "taylor")):
        skip_cfg = E2CRFConfig(level="score", eps_predictor=predictor, max_history=k)
        state = init_cache_state(skip_cfg, b, t_len, 1, "cuda").replace(
            cold=False, step=40, last_full_step=37, eps_hat=score, eps_prev=score * 0.9,
            eps_gap=torch.ones((), device="cuda"))
        if predictor == "freqca":
            state = state.replace(
                hist_len=torch.full((), k, dtype=torch.int32, device="cuda"),
                crf_t_hist=torch.linspace(0.99, 0.9, k, device="cuda"), crf_low=score * 0.5,
                crf_high_hist=torch.randn((k, b, t_len, 1), generator=gen, device="cuda"))
        device_breakdown(torch, label, lambda: psampler._skip(state, skip_cfg, t, std, t_len),
                         reps=50, top=6)
    return chains


def eval_phase(torch, bda, model, dm) -> dict:
    """Sample quality of the trained flagship, as ``cli/sample.py`` computes
    it: τ₀ calibration, then the uncached and the cached chain mapped back to
    the data domain and scored against the train set."""
    from functools import partial

    from fdtpu_torch.metrics import MarginalWasserstein, MetricCollection, SlicedWasserstein
    from fdtpu_torch.ops import idft
    from fdtpu_torch.sampling import DiffusionSampler, calibrate_tau_0

    layers = model.config.num_layers
    base = {k: v for k, v in CACHE_KWARGS.items() if k != "tau_0"}
    torch.cuda.synchronize()
    bda.launches = 0
    t0 = time.perf_counter()
    cal = calibrate_tau_0(model, num_samples=NUM_SAMPLES, num_diffusion_steps=NUM_STEPS,
                          sample_batch_size=SAMPLE_BATCH, seed=3, cache_kwargs=base)
    torch.cuda.synchronize()
    cal_seconds = time.perf_counter() - t0
    steps = NUM_STEPS * (NUM_SAMPLES // SAMPLE_BATCH)
    forwards = 2 * steps + sum(round(steps * (1 - a.steps_skipped_ratio)) for a in cal.arms)
    cal_launches = bda.launches
    print("eval: calibration", json.dumps(dict(
        tau_0=cal.tau_0, sw_noise_floor=cal.sw_noise_floor, seconds=cal_seconds,
        launches_b1=cal_launches, cache_kwargs=cal.cache_kwargs,
        arms=[dict(dataclasses.asdict(a), accepted=a.accepted) for a in cal.arms])), flush=True)
    check(math.isfinite(cal.sw_noise_floor) and cal.sw_noise_floor > 0,
          f"calibration: noise floor {cal.sw_noise_floor}")
    check(len(cal.arms) >= 1 and all(math.isfinite(a.sw_vs_uncached) for a in cal.arms),
          "calibration: an arm's SW is not finite")
    check(cal_launches == layers * forwards,
          f"calibration: {cal_launches} B1 launches for {forwards} full forwards x {layers}")

    metrics = MetricCollection(
        [partial(SlicedWasserstein, random_seed=METRICS_SEED, num_directions=SW_DIRECTIONS,
                 save_all_distances=True),
         partial(MarginalWasserstein, random_seed=METRICS_SEED, save_all_distances=True)],
        original_samples=dm.X_train, include_baselines=True, include_spectral_density=True)
    mean, std = dm.feature_mean_and_std
    result = dict(calibration_tau_0=cal.tau_0, sw_noise_floor=cal.sw_noise_floor,
                  calibration_seconds=cal_seconds, launches=cal_launches)
    for name, use_cache in (("uncached", False), ("cached", True)):
        sampler = DiffusionSampler(model, SAMPLE_BATCH, use_cache=use_cache,
                                   cache_kwargs=CACHE_KWARGS if use_cache else None)
        torch.cuda.synchronize()
        bda.launches = 0
        t0 = time.perf_counter()
        x = sampler.sample(NUM_SAMPLES, NUM_STEPS,
                           generator=torch.Generator(device="cuda").manual_seed(4))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        stats = sampler.get_cache_stats()
        full = stats["full_steps"] if use_cache else steps
        check(bda.launches == layers * full,
              f"eval {name}: {bda.launches} B1 launches for {full} full forwards x {layers}")
        result["launches"] += bda.launches
        # Back to the data domain (cli/sample.py:139-143).
        data = x.cpu().numpy() * std + mean
        series = idft(torch.from_numpy(data).float())
        check(tuple(series.shape) == (NUM_SAMPLES, model.config.max_len, 1),
              f"eval {name}: series shape {tuple(series.shape)}")
        check(bool(torch.isfinite(series).all()), f"eval {name}: series not finite")
        t0 = time.perf_counter()
        scores = metrics(series)
        metric_seconds = time.perf_counter() - t0
        scalars = {k: v for k, v in scores.items() if not isinstance(v, list)}
        check(all(math.isfinite(v) for v in scalars.values()),
              f"eval {name}: a metric is not finite")
        line = dict(samples_per_s=NUM_SAMPLES / seconds, seconds=seconds,
                    metric_seconds=metric_seconds, steps_skipped_ratio=stats.get(
                        "steps_skipped_ratio", 0.0), metrics=scalars)
        print(f"eval: {name}", json.dumps(line), flush=True)
        result[name] = line
    return result


def train_phase(torch, bda) -> dict:
    """The flagship's training path: one step's gradients, kernel path
    against einsum path; 2 epochs of ``Trainer.fit``; train throughput.
    Returns the result, the trained model and the datamodule."""
    from fdtpu_torch.data import SyntheticDatamodule
    from fdtpu_torch.diffusion import VPScheduler, sde_loss
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
    from fdtpu_torch.train import Trainer, get_training_params, make_optimizer, train_step

    cfg = ScoreModelConfig(n_channels=1, max_len=TRAIN_FLAGSHIP["seq"],
                           attention_impl="blockdiag")
    scheduler = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(cfg.max_len, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        dm = SyntheticDatamodule(tmp, max_len=cfg.max_len, num_samples=TRAIN_SAMPLES,
                                 batch_size=TRAIN_FLAGSHIP["batch"], fourier_transform=True,
                                 standardize=True)
        dm.prepare_data()
        dm.setup()
        batch = torch.from_numpy(next(iter(dm.train_dataloader()))).cuda()

        # One step's gradients with dropout on, kernel path against einsum
        # path: the same weights, t, z and dropout masks (same generator seed).
        g = torch.Generator(device="cuda").manual_seed(5)
        t = torch.rand((len(batch),), generator=g, device="cuda") * (1 - 1e-5) + 1e-5
        z = torch.randn(batch.shape, generator=g, device="cuda")
        grads, losses = [], []
        for impl in ("blockdiag", "einsum"):
            net = init_score_model(dataclasses.replace(cfg, attention_impl=impl),
                                   torch.Generator().manual_seed(0)).requires_grad_(True)
            loss = sde_loss(net, scheduler, batch, torch.Generator(device="cuda").manual_seed(6),
                            timesteps=t, noise=z)
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append(torch.cat([p.grad.flatten() for p in net.parameters()]))
        grad_err = float((grads[0] - grads[1]).abs().max())
        grad_max = float(grads[1].abs().max())
        print(f"train: one step, kernel vs einsum path: loss {losses[0]:.6g} vs {losses[1]:.6g}, "
              f"gradient max_abs_err {grad_err:.3g} (max |grad| {grad_max:.3g})", flush=True)
        # Tolerance: 1e-4 relative to the largest gradient; the two paths sum
        # the attention in other orders in float32 through 10 layers.
        check(abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1]), "train step: losses differ")
        check(grad_err <= 1e-4 * grad_max, f"train step: gradient error {grad_err:.3g} "
              f"> 1e-4 x {grad_max:.3g}")

        net = init_score_model(cfg, torch.Generator().manual_seed(0))
        model = ScoreModel(config=cfg, network=net, scheduler=scheduler,
                           num_training_steps=get_training_params(dm, TRAIN_EPOCHS)[
                               "num_training_steps"])
        trainer = Trainer(max_epochs=TRAIN_EPOCHS, run_dir=tmp, run_id="smoke", seed=42,
                          log_every_n_steps=10_000)
        torch.cuda.synchronize()
        bda.launches = bda.launches_bwd = bda.launches_trainable = 0
        t0 = time.perf_counter()
        trainer.fit(model, dm)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = dict(launches=bda.launches, launches_bwd=bda.launches_bwd,
                      launches_trainable=bda.launches_trainable)
        records = [json.loads(line) for line in trainer.metrics_path.read_text().splitlines()]
    epochs = [r for r in records if "val/loss" in r]
    steps = TRAIN_EPOCHS * len(dm.train_dataloader())
    val_forwards = TRAIN_EPOCHS * len(dm.val_dataloader())
    print("train: epochs", json.dumps(epochs), flush=True)
    check(len(epochs) == TRAIN_EPOCHS, f"train: {len(epochs)} epoch records")
    check(all(math.isfinite(r[k]) for r in epochs for k in ("train/loss_epoch", "val/loss")),
          "train: loss not finite")
    check(epochs[1]["train/loss_epoch"] < epochs[0]["train/loss_epoch"],
          "train: the second epoch's train loss is not below the first's")
    layers = cfg.num_layers
    check(counts["launches_bwd"] == layers * steps,
          f"train: {counts['launches_bwd']} B2 launches for {steps} steps x {layers} layers")
    check(counts["launches_trainable"] == layers * steps,
          f"train: {counts['launches_trainable']} B3 backward passes for {steps} steps")
    check(counts["launches"] == layers * (steps + val_forwards),
          f"train: {counts['launches']} B1 launches for {steps} + {val_forwards} forwards")
    check(not any(p.requires_grad for p in model.network.parameters()),
          "train: the returned network is not frozen")

    # Steady-state step time on one batch, and where a step's device time goes.
    net = init_score_model(cfg, torch.Generator().manual_seed(0)).requires_grad_(True)
    optimizer = make_optimizer(net.parameters(), model.lr_max, 1000)
    gen = torch.Generator(device="cuda").manual_seed(7)

    def step():
        return train_step(net, optimizer, scheduler, batch, gen)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 20
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    ms_per_step = 1e3 * (time.perf_counter() - t0) / n

    # The same step cut at synchronizations: loss forward, backward, clip + AdamW.
    split = [0.0, 0.0, 0.0]
    for _ in range(n):
        marks = [time.perf_counter()]
        loss = sde_loss(net, scheduler, batch, gen)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        optimizer.zero_grad()
        loss.backward()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        optimizer.step()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for i in range(3):
            split[i] += 1e3 * (marks[i + 1] - marks[i]) / n
    result = dict(fit_seconds=fit_s, train_samples_per_s=TRAIN_EPOCHS * TRAIN_SAMPLES / fit_s,
                  ms_per_step=ms_per_step, split_ms=dict(zip(("loss", "backward", "optimizer"),
                                                             split)),
                  step_samples_per_s=1e3 * TRAIN_FLAGSHIP["batch"] / ms_per_step,
                  steps=steps, val_forwards=val_forwards, best_val_loss=trainer.best_val_loss,
                  grad_max_abs_err=grad_err, **counts)
    print("train", json.dumps(result), flush=True)
    device_breakdown(torch, "train-step", step, reps=5, top=10, no_grad=False)
    return result, model, dm


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from fdtpu_torch.kernels import attention as mha
        from fdtpu_torch.kernels import blockdiag_attention as bda
        from fdtpu_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: fdtpu_torch is not importable here ({exc})", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    build.build([bda.SOURCE, bda.SOURCE_BWD, mha.SOURCE], verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    kernel_results = kernel_phase(torch, bda)
    mha_results = mha_kernel_phase(torch, mha)
    bwd_results = bwd_kernel_phase(torch, bda)
    trainable = trainable_phase(torch, bda)
    head_dim_sweep(torch, bda, mha)
    chains = slice_phase(torch, bda)
    levels = levels_phase(torch, bda, mha)
    freq_chains = freq_options_phase(torch, bda, mha)
    train, trained, dm = train_phase(torch, bda)
    evaluation = eval_phase(torch, bda, trained, dm)
    level_chains = [c for c in levels.values() if isinstance(c, dict)]
    level_chains += list(freq_chains.values())

    def kernel_record(name, source, replaces, launches, results):
        # The head case is the first float32 one; "cases" keeps every case's times.
        fp32 = [r for r in results if r["dtype"] == "float32"]
        head = fp32[0]
        cases = [{"case": r["case"], "shape": r["shape"], "dtype": r["dtype"],
                  "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                  "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                  "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                  **{key: r[key] for key in ("device_ms", "same_input_err")
                     if key in r}} for r in results]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in fp32),
                "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "cases": cases}

    records = [
        kernel_record("blockdiag_mha", "fdtpu_torch/kernels/csrc/blockdiag_attention.cu",
                      "fdtpu/kernels/blockdiag_attention.py:221",
                      sum(c["launches"] for c in chains.values()) + train["launches"]
                      + sum(c["launches_b1"] for c in level_chains) + evaluation["launches"],
                      kernel_results),
        kernel_record("fused_mha", "fdtpu_torch/kernels/csrc/fused_attention.cu",
                      "fdtpu/kernels/attention.py:80",
                      sum(c["launches_b4"] for c in level_chains), mha_results),
        kernel_record("blockdiag_mha_bwd", "fdtpu_torch/kernels/csrc/blockdiag_attention_bwd.cu",
                      "fdtpu/kernels/blockdiag_attention.py:373", train["launches_bwd"],
                      bwd_results),
        {"name": "blockdiag_mha_trainable", "route": "autograd.Function",
         "source": "fdtpu_torch/kernels/blockdiag_attention.py",
         "replaces": "fdtpu/kernels/blockdiag_attention.py:410",
         "launches": train["launches_trainable"], "max_abs_err": trainable["max_abs_err"],
         "ms": trainable["ms"], "plain_ms": trainable["plain_ms"],
         "bound_ms": trainable["bound_ms"], "bound_by": trainable["bound_by"],
         "library_ms": trainable["library_ms"]},
    ]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
