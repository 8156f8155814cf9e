#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fdtpu_torch``) on one NVIDIA GPU and check it.

Usage, from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py
    python3 chip_smoke.py --step-times   # only the eager and resident ms/step
                                         # of the uncached and score chains
    python3 chip_smoke.py --export-window   # only the exported token program's
                                            # profile beside the eager loop's

Phases (any failure exits non-zero and prints no result):

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; builds the CUDA sources of ``fdtpu_torch/kernels/csrc`` (B1,
   B2, B4 and the conditional-node helper), one ``nvcc`` per source, in
   parallel.
2. Kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the main path's shapes (B1 at the serving batch, B2 at the
   training batch, B4 at the token level's rows against all keys, at the
   KV level's square shape and past 5000 keys), with its time (and B4's
   device time from the profiler), the plain version's time, a
   one-call PyTorch yardstick (``library_ms``, timed only) and the least time
   the card could take (``bound_ms``); then B3, the autograd Function over B1
   and B2, against autograd through the plain forward, and its device time;
   B1's and B2's float32 and B4's float32 and bfloat16 times at head_dim
   4..32 (which pipe binds), each beside its plain version's (where
   ``attention_impl="auto"`` crosses over).
3. Slice: the flagship score model (d_model 72, 10 layers, 12 heads, FFN
   2048, 187 frequency tokens; random weights from a seed) on CUDA with the
   block-diagonal attention kernel: ``score_apply`` against the einsum path
   and against the CPU; a 50-step uncached chain CUDA against the CPU; where
   a 200-step score-level chain's time goes.  The T = 1000 uncached and
   score-level chains are the graphs phase's.
4. Token and KV levels: a 50-step token-level chain on CUDA against the CPU
   (the same noise and probe uniforms; the same mode at every step); the
   token level at ``cli/ablation_cache.py``'s ``token_full`` arm (256
   samples, batches of 128, T = 1000) and the KV level's event arm
   (``kv_event_arm(10)``) and macro policy (``cli/benchmark_cache.py``) on one
   batch of 128, T = 200, with B1 counted once per layer and FULL step and B4 once per
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
   three chains at T = 200 on one batch of 128 with B1 and B4 counted; where
   a FreSca call's and a FreqCa skip step's time goes.
7. Evaluation, on the network phase 5 trained: ``calibrate_tau_0`` (256 pilot
   samples, T = 1000, batches of 128, the score level's operating point
   without τ₀), then 256 samples uncached and 256 at the operating point,
   taken back to the data domain and scored with ``MetricCollection``
   (sliced Wasserstein over 1000 directions and marginal Wasserstein, time
   and frequency domain, spectral density, self-split and dummy baselines)
   against the datamodule's train set.  Quality is printed, not gated; B1's
   launches are counted.  It runs at ``configs/sampler/default.yaml``'s
   ``batches_per_call: 2``: the resident chain.
8. Graphs (run before 5): each flagship chain (uncached, score, token, KV
   event and macro, the three of phase 6) on 256 samples in batches of 128,
   with ``batches_per_call`` 1 (the eager loop, a device read a step) and 2
   (the resident chain: each trajectory one replay of a graph with a WHILE
   node over the steps and an IF node per branch, the E²-CRF decisions
   taken on the device): the same mode at every step, equal cache
   statistics, samples bitwise equal, the launch checks through replays, B1
   and B4 inside the branches; two resident trajectories alone run under
   ``set_sync_debug_mode("error")`` (no device read inside), with their
   device span over their wall time.  The uncached, score and token chains
   (``REFERENCE_CHAINS``) run at T = 1000, their samples (uncached, score)
   taken back to the time domain, with ms/step, samples/s, and in a
   profiled call of two 50-step trajectories the launch API calls a
   trajectory, the device-to-host copies a call (at most one, the
   statistics) and the busy share; the KV and FreqCa/FreSca chains run at
   T = 200 (their T = 1000 times are PERF.md §5's).
   ``Trainer.fit`` at ``steps_per_call`` 1 and 16 (samples/s; per-step
   losses and final parameters against each other at the JAX chunking
   test's tolerances), 16 steps eager against one call of 16 replays
   (ms/step, busy share, B1–B3 inside the step graph), and at
   ``epochs_per_call`` 2 (the device-resident epoch loop, a captured graph
   a call) over 2 × 2 epochs.  Phase 5's ``Trainer.fit`` runs at the
   default ``steps_per_call`` (16).
   Export (after the graphs): the uncached, score-level and token-level
   chains (``EXPORT_CHAINS``) at the flagship's full width, T = 1000, a
   batch of 128, exported with ``fdtpu_torch.serve.export_sampler``, loaded
   with ``load_exported`` and run from a generator, then held to
   ``DiffusionSampler.sample``'s first batch from the same generator
   ("export <chain>" lines: export, load, run seconds, ms/step, the
   artifact's bytes, B1 and B4 launched inside the program, the difference).
9. CLIs: ``python -m fdtpu_torch.cli.train``'s ``main`` on the synthetic
   data (2000 samples of 187, 2 epochs, ``configs/train.yaml`` and the
   default score model at its full width, ``attention_impl: auto`` resolving
   to B1) with B1–B3 counted; ``Trainer(resume=True)`` after one epoch
   against two straight epochs (losses, rates, parameters, optimizer and
   generator state bitwise); one epoch at ``accumulate_grad_batches=2``;
   ``fdtpu_torch.cli.sample``'s ``main`` on that run, 256 samples at
   T = 1000 in ``configs/sampler/default.yaml``'s batches of 50 (4 batches
   resident at its ``batches_per_call`` 2, the fifth too), uncached,
   at the score level's operating point and at the token level's
   ``token_full`` arm, with B1 = 10 × full forwards and B4 = 10 × TOPK steps
   and the "eval:"-style metrics of ``results.yaml``; the MLP and LSTM
   backbones at their configs' widths, one train-CLI epoch each, then a
   50-step uncached chain on their weights CUDA against the CPU.
10. Data: the ECG raw tree written by ``fdtpu_torch.data.fixtures`` at
   MIT-BIH's published size (87,554 and 21,892 rows of 188 columns) and read
   by ``ECGDatamodule`` (seconds to write and to parse); the NASDAQ, NASA
   (charge, discharge) and droughts trees at the JAX fixtures' sizes and
   MIMIC from its ``.npy`` form, through ``prepare_data`` and ``setup``;
   ``localization_metrics`` and ``smooth_frequency`` on CUDA against the CPU
   over the ECG train set, with the 1000 series ``subsample_localization``
   keeps compared; the flagship trained 2 epochs on ECG through the train
   CLI (``subsample_localization``, full width, B1–B3 counted); the sample
   CLI on that run at ``configs/sample.yaml``'s defaults, uncached and at the
   score level; then ``fdtpu_torch.cli.ablation_cache`` and
   ``benchmark_cache`` on it at those defaults from a temporary working
   directory (every arm's row, finite values, cache statistics counting the
   steps run; wall time, B1 and B4 launches).  ``benchmark_cache`` runs its
   headline arms (``run_ablations=false``): with its 19 sweep arms the phase
   took 241 s on the H100, past its 200 s share of the script (PERF.md §5).
11. Table 2 and the viz tables, last: ``fdtpu_torch.cli.validate_real_data``
   in this process on ECG at MIT-BIH's size (the data phase's tree, written
   anew), both domains, the flagship at full width trained 2 epochs on the
   1000 localized beats, 256 samples at T = 1000 in batches of 128,
   uncached and at the score level's operating point ("table2 <domain>"
   lines: train and sample seconds, skipped share, time-domain SW, B1 = 10
   × full forwards and B2 = B3 = 10 × train steps); its JSON held to the
   Table-2 schema; ``all --fixture --smoke --domains frequency`` over the
   seven fixture trees ("table2 fixtures"); then ``fdtpu_torch.viz`` on
   those run directories (per-distance rows, summary tables as CSV and
   LaTeX, the run table, spectral profiles; each file checked written) and
   ``spectral_interpretation.process_dataset`` on the MIT-BIH-size ECG
   datamodule with the localization on the card ("viz" line).  Figures are
   not drawn: the card's machine has no matplotlib.

The levels and freq phases run their KV and FreqCa chains on one batch at
T = 200 (``SHORT_CHAIN_STEPS``): the graphs phase runs each at T = 1000.

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
# The depth of the levels and freq phases' KV and FreqCa chains on one batch:
# the graphs phase runs the same chains at T = 1000 (its eager twins).
SHORT_CHAIN_STEPS = 200
# The sampler's FreqCa and FreSca options on the flagship's operating points.
FREQ_CHAINS = {
    "score-freqca": (dict(CACHE_KWARGS, eps_predictor="freqca"), {}),
    "score-fresca": (CACHE_KWARGS, {"use_fresca": True, "fresca_cutoff_strategy": "energy"}),
    "kv-event-freqca": (dict(KV_EVENT_KWARGS, use_freqca=True), {}),
}
# The chains the graphs phase runs eager and as replays of captured graphs.
GRAPH_CHAINS = {
    "uncached": (None, {}),
    "score": (CACHE_KWARGS, {}),
    "token": (TOKEN_KWARGS, {}),
    "kv-event": (KV_EVENT_KWARGS, {}),
    "kv-macro": (KV_MACRO_KWARGS, {}),
    **FREQ_CHAINS,
}
# The chains whose T = 1000 numbers are the port's reference: the graphs
# phase runs them at NUM_STEPS and profiles a window of each; the KV and
# FreqCa/FreSca chains run there at SHORT_CHAIN_STEPS (their T = 1000 eager
# and resident times are PR 9's, PERF.md §5).
REFERENCE_CHAINS = ("uncached", "score", "token")
# The chains the export phase exports at NUM_STEPS, and those whose step
# times ``--step-times`` reads.
EXPORT_CHAINS = ("uncached", "score", "token")
STEP_TIME_CHAINS = ("uncached", "score")
# The exported program against the sampler on the same card: the same
# functions on the same draws, so any difference past this is a fault.
EXPORT_REL_TOL = 1e-5
# The graphs phase's profiled window: one call of two trajectories of this many steps.
WINDOW_STEPS = 50
# configs/sampler/default.yaml's batches_per_call, at which the evaluation runs.
EVAL_BATCHES_PER_CALL = 2
# configs/metrics/default.yaml with cli/sample.py's random_seed.
METRICS_SEED = 42
SW_DIRECTIONS = 1000
# B4 in bfloat16 against the plain version of the same bfloat16 inputs: the
# limit past rtol 2^-7, four times the largest reading on the H100 (1.95e-3,
# PERF.md §6).
MHA_SAME_ATOL = 8e-3
# MIT-BIH's published rows (Kaggle shayanfazeli/heartbeat: mitbih_train.csv,
# mitbih_test.csv), 188 columns each.
ECG_ROWS = (87554, 21892)
# ECG's frequency smoothing width checked CUDA against the CPU.
ECG_SMOOTHER_WIDTH = 5.0
# The CUDA API calls that put work on the card, as the profiler names
# them: one kernel each, or one whole captured graph.
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaGraphLaunch")


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
    head_dim, so a time that follows head_dim is the FMA (or tensor) pipe's.
    Beside each, the plain version's time on the same inputs: the crossover
    that ``attention_impl="auto"`` takes (``resolve_attention_impl``)."""
    g = torch.Generator(device="cuda").manual_seed(13)
    for dh in (4, 6, 8, 16, 32):
        for name, (b, t, h, _) in (("blockdiag_mha", FLAGSHIP.values()),
                                   ("blockdiag_mha_bwd", TRAIN_FLAGSHIP.values())):
            q = torch.randn((b, t, h * dh), generator=g, device="cuda")
            k = torch.randn((b, h, dh, t), generator=g, device="cuda")
            v = torch.randn((b, h, t, dh), generator=g, device="cuda")
            if name == "blockdiag_mha":
                ms = time_ms(torch, lambda: bda.blockdiag_mha_cuda(q, k, v))
                plain_ms = time_ms(torch, lambda: bda.blockdiag_mha_plain(q, k, v))
            else:
                ms = time_ms(torch, lambda: bda.blockdiag_mha_bwd_cuda(q, k, v, q))
                plain_ms = time_ms(torch, lambda: bda.blockdiag_mha_bwd_plain(q, k, v, q))
            print("kernel_sweep", json.dumps({"kernel": name, "shape": [b, t, h, dh],
                                              "dtype": "float32", "ms": ms,
                                              "plain_ms": plain_ms}), flush=True)
        b, t, h, _ = FLAGSHIP.values()
        q, k, v = (torch.randn((b, t, h, dh), generator=g, device="cuda") for _ in range(3))
        for dtype in (torch.float32, torch.bfloat16):
            args = [a.to(dtype) for a in (q, k, v)]
            ms = time_ms(torch, lambda: mha.fused_mha_cuda(*args))
            plain_ms = time_ms(torch, lambda: mha.mha_plain(*args))
            print("kernel_sweep", json.dumps({"kernel": "fused_mha", "shape": [b, t, t, h, dh],
                                              "dtype": str(dtype).split(".")[-1], "ms": ms,
                                              "plain_ms": plain_ms}), flush=True)


def device_breakdown(torch, label: str, fn, reps: int = 3, top: int = 8,
                     no_grad: bool = True, warm_up: bool = True) -> dict:
    """Device time of ``fn`` by kernel (torch.profiler) and the share of its
    wall time (measured under the profiler) that the device was busy; one
    unprofiled call first unless ``warm_up`` is False."""
    from torch.profiler import ProfilerActivity, profile

    with torch.set_grad_enabled(not no_grad):
        if warm_up:
            fn()
        torch.cuda.synchronize()
        # Device activity only: the kernels and the runtime's launch calls,
        # without an event per PyTorch operator (a quarter of the trace to
        # read, and less overhead in the window).
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    t_read = time.perf_counter()
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
        return dict(wall_ms=wall_ms, busy_ms=0.0, busy_share=0.0, api_calls={}, d2h=0,
                    records={})
    calls = {e.key: e.count / reps for e in prof.key_averages() if e.key in LAUNCH_APIS}
    # Device-to-host copies (a .item(), .tolist() or .cpu() each), by the
    # copy activities the profiler records on the device.
    d2h = sum(count for _, count, name in rows if name.startswith("Memcpy DtoH"))
    launched = int(calls.get("cudaLaunchKernel", 0))
    graph_launches = int(calls.get("cudaGraphLaunch", 0))
    print(f"breakdown {label}: wall {wall_ms:.4f} ms, device busy {busy:.4f} ms "
          f"({100 * busy / wall_ms:.1f}%), {launched} cudaLaunchKernel calls, "
          f"{graph_launches} cudaGraphLaunch calls, {d2h} device-to-host copies (trace read in "
          f"{time.perf_counter() - t_read:.1f} s)", flush=True)
    for ms, count, name in rows[:top]:
        print(f"breakdown {label}: {ms:9.4f} ms {100 * ms / busy:5.1f}% x{count:<5d} "
              f"{name[:90]}", flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy, busy_share=busy / wall_ms, api_calls=calls,
                d2h=d2h, records={name: count for _, count, name in rows})


def slice_phase(torch, bda) -> dict:
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model, score_apply
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

    # Where a score-level chain's time goes: one batch of 200 steps, profiled.
    window = DiffusionSampler(model, SAMPLE_BATCH, use_cache=True, cache_kwargs=CACHE_KWARGS)
    device_breakdown(
        torch, "cached-chain-200-steps",
        lambda: window.sample(SAMPLE_BATCH, 200, generator=torch.Generator("cuda").manual_seed(3)),
        reps=1, top=6,
    )
    return {"forward_kernel_ms": fwd_kernel_ms, "forward_einsum_ms": fwd_einsum_ms}


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
    from fdtpu_torch.sampling import DiffusionSampler, resident, sample_chain
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
        modes, undo_modes = recording(resident, "token_policy", lambda out: int(out[0]))
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
    for name, kwargs, num_samples, num_steps in (
            ("token", TOKEN_KWARGS, NUM_SAMPLES, NUM_STEPS),
            ("kv-event", KV_EVENT_KWARGS, SAMPLE_BATCH, SHORT_CHAIN_STEPS),
            ("kv-macro", KV_MACRO_KWARGS, SAMPLE_BATCH, SHORT_CHAIN_STEPS)):
        sampler = DiffusionSampler(model, SAMPLE_BATCH, use_cache=True, cache_kwargs=kwargs)
        gen = torch.Generator(device="cuda").manual_seed(2)
        torch.cuda.synchronize()
        bda.launches = mha.launches = 0
        t0 = time.perf_counter()
        samples = sampler.sample(num_samples, num_steps, generator=gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        b1, b4 = bda.launches, mha.launches
        stats = sampler.get_cache_stats()
        steps = num_steps * (num_samples // SAMPLE_BATCH)
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
    from fdtpu_torch.sampling import DiffusionSampler, resident, sample_chain
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
            modes, undo_modes = recording(
                resident, policy, lambda out: int(out[0] if isinstance(out, tuple) else out))
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
        samples = sampler.sample(SAMPLE_BATCH, SHORT_CHAIN_STEPS, generator=gen)
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
                            ms_per_step=1e3 * seconds / SHORT_CHAIN_STEPS, launches_b1=b1,
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
        device_breakdown(torch, label, lambda: psampler._skip(state, skip_cfg, t, std),
                         reps=50, top=6)
    return chains


def graphs_phase(torch, bda, mha) -> tuple[dict, dict]:
    """Each flagship chain with ``batches_per_call`` 1 (the eager loop, a
    device read a step) and 2 (the resident chain: a trajectory one replay
    of a graph whose conditional nodes take the decisions), 256 samples in
    batches of 128, T = 1000 for ``REFERENCE_CHAINS`` and T = 200 for the
    others (which skip the profiled window): the same mode at every step
    (``last_modes``), the same cache statistics, samples bitwise equal, B1
    and B4 counted through the replays; ms/step and samples/s (the resident
    chain's without its first call's capture, timed apart); then one call
    of 2 trajectories × ``WINDOW_STEPS`` steps, profiled: the launch API
    calls a trajectory, the device-to-host copies a call (at most one for
    the resident chain) and the device's busy share (where the profiler saw
    every kernel); then two resident trajectories alone under
    ``set_sync_debug_mode("error")`` (no read of the device) with their
    device span over their wall time.  The uncached and score-level samples
    are taken back to the time domain.  Then training.  Returns the lines and,
    for ``EXPORT_CHAINS``, the eager loop's first batch and its modes."""
    from fdtpu_torch.data import SyntheticDatamodule
    from fdtpu_torch.ops import idft
    from fdtpu_torch.sampling import DiffusionSampler

    model = flagship_model(torch)
    cfg = model.config
    print(f"graphs: flagship {model.param_count()} parameters", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        dm = SyntheticDatamodule(tmp, max_len=cfg.max_len, num_samples=1000,
                                 fourier_transform=True, standardize=True)
        dm.prepare_data()
        dm.setup()
        mean, std = dm.feature_mean_and_std
    layers = cfg.num_layers
    results, first_batches = {}, {}
    for name, (kwargs, options) in GRAPH_CHAINS.items():
        level = kwargs["level"] if kwargs else None
        num_steps = NUM_STEPS if name in REFERENCE_CHAINS else SHORT_CHAIN_STEPS
        steps = num_steps * (NUM_SAMPLES // SAMPLE_BATCH)
        runs = {}
        t_chain = time.perf_counter()
        for per_call in (1, 2):
            def make():
                return DiffusionSampler(model, SAMPLE_BATCH, use_cache=kwargs is not None,
                                        cache_kwargs=kwargs, batches_per_call=per_call, **options)

            sampler = make()
            torch.cuda.synchronize()
            bda.launches = mha.launches = 0
            samples, first_call, captures = timed_sample(torch, sampler, num_steps)
            # The resident chain's first call captures its graph: its steps
            # are timed without the capture.
            seconds = first_call - sum(captures)
            b1, b4 = bda.launches, mha.launches
            stats = sampler.get_cache_stats()
            full = stats["full_steps"] if kwargs else steps
            b4_steps = 0
            if level == "token":
                b4_steps = stats["mixed_steps"]
            elif level == "kv":
                b4_steps = stats["mixed_steps"] + stats["cached_steps"]
            check(tuple(samples.shape) == (NUM_SAMPLES, cfg.max_len, 1),
                  f"graphs {name}: samples shape {tuple(samples.shape)}")
            check(bool(torch.isfinite(samples).all()), f"graphs {name}: samples not finite")
            check(b1 == layers * full,
                  f"graphs {name} x{per_call}: {b1} B1 launches for {full} full forwards")
            check(b4 == layers * b4_steps,
                  f"graphs {name} x{per_call}: {b4} B4 launches for {b4_steps} steps")
            if name in ("uncached", "score"):
                series = idft(torch.from_numpy(samples.cpu().numpy() * std + mean).float())
                check(bool(torch.isfinite(series).all()),
                      f"graphs {name}: de-standardized series not finite")
            run = dict(steps=num_steps, ms_per_step=1e3 * seconds / steps,
                       samples_per_s=NUM_SAMPLES / seconds, launches_b1=b1, launches_b4=b4)
            if per_call > 1:
                run.update(capture_seconds=sum(captures),
                           first_call_ms_per_step=1e3 * first_call / steps)
                (chain,) = sampler._chains.values()
                check(chain.loop is not None, f"graphs {name}: no trajectory graph was captured")
                inside = [seg.launched for seg in chain.loop.branches]
                run.update(branches=len(inside), b1_in_branches=sum(n[0] for n in inside),
                           b4_in_branches=sum(n[3] for n in inside))
                check(run["b1_in_branches"] > 0, f"graphs {name}: no branch holds B1")
                if b4_steps:
                    check(run["b4_in_branches"] > 0, f"graphs {name}: no branch holds B4")
            if name not in REFERENCE_CHAINS:
                modes = sampler.last_modes
                if per_call > 1:
                    run.update(resident_trajectories(torch, sampler))
                runs[per_call] = (samples, modes, stats, run)
                continue
            # One call of two short trajectories, profiled (the resident
            # chain's first call captures its graph: it is run once before).
            window = make()
            window_steps = 2 * WINDOW_STEPS
            b1_before = bda.launches
            prof = device_breakdown(
                torch, f"graphs-{name}-x{per_call}-{window_steps}-steps",
                lambda: window.sample(2 * SAMPLE_BATCH, WINDOW_STEPS,
                                      generator=torch.Generator("cuda").manual_seed(3)),
                reps=1, top=3, warm_up=per_call > 1)
            # The profiler (CUPTI) may miss kernels of conditional bodies:
            # the busy share stands only where it saw every B1 launch.
            b1_window = (bda.launches - b1_before) // (2 if per_call > 1 else 1)
            seen = sum(n for k, n in prof["records"].items() if "blockdiag_mha_fwd" in k)
            complete = seen == b1_window
            run.update(window_wall_ms_per_step=prof["wall_ms"] / window_steps,
                       window_busy_share=prof["busy_share"] if complete else None,
                       window_profiler_complete=complete,
                       calls_per_trajectory={k: v / 2 for k, v in prof["api_calls"].items()},
                       d2h_per_call=prof["d2h"])
            if per_call > 1:
                check(prof["d2h"] <= 1, f"graphs {name}: {prof['d2h']} device-to-host copies "
                      "in a call of two resident trajectories")
                run.update(resident_trajectories(torch, window))
            runs[per_call] = (samples, sampler.last_modes, stats, run)
        (s1, m1, st1, r1), (s2, m2, st2, r2) = runs[1], runs[2]
        differ = [] if m1 is None else (m1 != m2).nonzero()[:1].tolist()
        line = dict(eager=r1, resident=r2, modes_compared=0 if m1 is None else m1.numel(),
                    phase_seconds=time.perf_counter() - t_chain, first_mode_divergence=differ,
                    max_abs_diff=float((s1 - s2).abs().max()),
                    bitwise_equal=bool(torch.equal(s1, s2)), cache_stats_equal=st1 == st2)
        print(f"graphs {name}", json.dumps(line), flush=True)
        check((m1 is None) == (m2 is None) and not differ,
              f"graphs {name}: modes diverge first at (batch, step) {differ}")
        check(st1 == st2, f"graphs {name}: cache statistics differ: {st1} vs {st2}")
        check(line["bitwise_equal"], f"graphs {name}: samples differ by {line['max_abs_diff']:.3g}")
        results[name] = line
        if name in EXPORT_CHAINS:  # the export phase's reference: the eager first batch
            first_batches[name] = (s1[:SAMPLE_BATCH], None if m1 is None else m1[0])
    results["train"] = graphs_train(torch, bda)
    return results, first_batches


def timed_sample(torch, sampler, num_steps: int) -> tuple:
    """``sampler.sample(NUM_SAMPLES, num_steps)`` from a seeded generator:
    the samples, the call's wall seconds and the seconds of each graph
    capture inside it (a resident chain captures at its first call)."""
    from fdtpu_torch.sampling import resident

    captures = []
    real_capture = resident.Chain._capture

    def timed_capture(self):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        real_capture(self)
        torch.cuda.synchronize()
        captures.append(time.perf_counter() - t1)

    resident.Chain._capture = timed_capture
    try:
        t0 = time.perf_counter()
        samples = sampler.sample(NUM_SAMPLES, num_steps,
                                 generator=torch.Generator(device="cuda").manual_seed(2))
        torch.cuda.synchronize()
        return samples, time.perf_counter() - t0, captures
    finally:
        resident.Chain._capture = real_capture


def flagship_model(torch):
    """The flagship score model at full width (random weights, seed 0) on
    the card, with VP and Fourier noise scaling."""
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model

    cfg = ScoreModelConfig(n_channels=1, max_len=FLAGSHIP["seq"], attention_impl="blockdiag")
    net = init_score_model(cfg, torch.Generator().manual_seed(0))
    scheduler = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(cfg.max_len, "cuda")
    return ScoreModel(config=cfg, network=net, scheduler=scheduler)


def step_times(torch) -> dict:
    """The eager loop's (``batches_per_call=1``) and the resident chain's
    (2) ms/step of ``STEP_TIME_CHAINS`` at the flagship, T = 1000, 256
    samples in batches of 128 (the resident chain without its capture): the
    steps that the kernels' dispatch lengthens.  ``python3 chip_smoke.py
    --step-times`` runs only this, so that one call can time the parent's
    tree and this one in turns."""
    from fdtpu_torch.sampling import DiffusionSampler

    model = flagship_model(torch)
    steps = NUM_STEPS * (NUM_SAMPLES // SAMPLE_BATCH)
    out = {}
    for name in STEP_TIME_CHAINS:
        kwargs, options = GRAPH_CHAINS[name]
        for per_call in (1, 2):
            sampler = DiffusionSampler(model, SAMPLE_BATCH, use_cache=kwargs is not None,
                                       cache_kwargs=kwargs, batches_per_call=per_call, **options)
            if per_call == 1:  # kernels and library handles made before the timed call
                sampler.sample(SAMPLE_BATCH, 5, generator=torch.Generator("cuda").manual_seed(1))
            _, seconds, captures = timed_sample(torch, sampler, NUM_STEPS)
            out[f"{name} {'eager' if per_call == 1 else 'resident'}"] = (
                1e3 * (seconds - sum(captures)) / steps)
    print("step_times", json.dumps(out), flush=True)
    return out


def export_phase(torch, bda, mha, first_batches: dict) -> dict:
    """Each of ``EXPORT_CHAINS`` at the flagship's full width, T = 1000, a
    batch of 128, through the serving entry points: exported with
    ``fdtpu_torch.serve.export_sampler``, loaded with ``load_exported`` and
    run once from the generator the graphs phase sampled from.  "export
    <chain>" lines: export, load and run seconds, the program's ms/step, the
    artifact's bytes, B1 and B4 launches in the program's run, and the
    largest difference from ``DiffusionSampler.sample``'s first batch from
    that generator (``first_batches``: the graphs phase's eager loop, its
    samples and modes); B1 must be 10 × that batch's full forwards and B4
    10 × its TOPK steps (the same decisions)."""
    from fdtpu_torch.sampling import DiffusionSampler
    from fdtpu_torch.serve import export_sampler, load_exported

    model = flagship_model(torch)
    layers = model.config.num_layers
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in EXPORT_CHAINS:
            kwargs, options = GRAPH_CHAINS[name]
            want, modes = first_batches[name]
            sampler = DiffusionSampler(model, SAMPLE_BATCH, use_cache=kwargs is not None,
                                       cache_kwargs=kwargs, **options)
            path = Path(tmp) / f"{name}.pt2"
            t0 = time.perf_counter()
            meta = export_sampler(sampler, NUM_STEPS, path)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fn = load_exported(path)
            load_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            bda.launches = mha.launches = 0
            t0 = time.perf_counter()
            got = fn(torch.Generator("cuda").manual_seed(2))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            b1, b4 = bda.launches, mha.launches
            # Score level: 1 a refresh; token level: 0 FULL, 1 TOPK.
            full = NUM_STEPS if modes is None else int((modes == int(name == "score")).sum())
            topk = int((modes == 1).sum()) if name == "token" else 0
            line = dict(export_s=export_s, artifact_bytes=path.stat().st_size, load_s=load_s,
                        run_s=run_s, ms_per_step=1e3 * run_s / NUM_STEPS,
                        launches_b1=b1, launches_b4=b4, full_forwards=full, topk_steps=topk,
                        max_abs_diff=float((got - want).abs().max()),
                        rel_err=rel_err(got, want), bitwise_equal=bool(torch.equal(got, want)),
                        draws=[d["name"] for d in meta["draws"]])
            print(f"export {name}", json.dumps(line), flush=True)
            check(tuple(got.shape) == (SAMPLE_BATCH, model.config.max_len, 1),
                  f"export {name}: samples shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"export {name}: samples not finite")
            check(b1 == layers * full and b4 == layers * topk,
                  f"export {name}: B1 {b1}, B4 {b4} launches for {full} full forwards and "
                  f"{topk} TOPK steps of the sampler's chain")
            check(line["rel_err"] <= EXPORT_REL_TOL,
                  f"export {name}: samples differ from the sampler's by {line['rel_err']:.3g}")
            results[name] = line
    return results


def export_window(torch) -> dict:
    """Where the exported program's step goes: the token chain's program
    (``WINDOW_STEPS`` steps, a batch of 128) and the eager loop from one
    generator, each profiled once after a warm-up call ("breakdown
    export-token-*" lines: wall, device busy share, launches, device reads),
    and the artifact's parts (the graph's JSON against the weights).
    ``python3 chip_smoke.py --export-window`` runs only this."""
    import zipfile

    from fdtpu_torch.sampling import DiffusionSampler
    from fdtpu_torch.serve import export_sampler, load_exported

    kwargs, options = GRAPH_CHAINS["token"]
    sampler = DiffusionSampler(flagship_model(torch), SAMPLE_BATCH, use_cache=True,
                               cache_kwargs=kwargs, **options)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "token.pt2"
        export_sampler(sampler, WINDOW_STEPS, path)
        entries = zipfile.ZipFile(path).infolist()
        out["graph_json_bytes"] = sum(e.file_size for e in entries if e.filename.endswith(".json"))
        out["weights_bytes"] = sum(e.file_size for e in entries if "/weights/" in e.filename)
        fn = load_exported(path)
        for name, run in (("program", fn), ("eager", lambda g: sampler.sample(
                SAMPLE_BATCH, WINDOW_STEPS, generator=g))):
            prof = device_breakdown(torch, f"export-token-{name}-{WINDOW_STEPS}-steps",
                                    lambda: run(torch.Generator("cuda").manual_seed(2)),
                                    reps=1, top=5)
            out[name] = dict(wall_ms_per_step=prof["wall_ms"] / WINDOW_STEPS,
                             busy_share=prof["busy_share"], d2h=prof["d2h"],
                             launches=prof["api_calls"].get("cudaLaunchKernel", 0))
    print("export_window", json.dumps(out), flush=True)
    return out


def resident_trajectories(torch, sampler) -> dict:
    """Two trajectories of ``sampler``'s resident chain back to back, alone
    (no cross-batch preparation, no end-of-call read), under
    ``set_sync_debug_mode("error")``: any read of the device raises.  Their
    device span (CUDA events) over their host wall time is the share of the
    wall the device held work; nothing the host does is inside the span."""
    (chain,) = sampler._chains.values()
    chain.begin_call(torch.Generator("cuda").manual_seed(4))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        chain.run_resident()
        chain.run_resident()
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    chain.read()
    span = start.elapsed_time(end)
    return dict(d2h_per_trajectory=0, trajectory_device_ms=span / 2,
                trajectory_wall_ms=wall_ms / 2, device_span_share=span / wall_ms)


def graphs_train(torch, bda) -> dict:
    """``Trainer.fit`` of the flagship, 2 epochs, at ``steps_per_call`` 1
    and 16: samples/s (logging once an epoch), then per-step losses and the
    final parameters (logging every step) against the JAX chunking test's
    tolerances; the steady step eager against replayed, with its busy
    share."""
    from fdtpu_torch.data import SyntheticDatamodule
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
    from fdtpu_torch.train import Trainer, get_training_params, make_optimizer, train_step
    from fdtpu_torch.train.trainer import GraphedSteps

    cfg = ScoreModelConfig(n_channels=1, max_len=TRAIN_FLAGSHIP["seq"],
                           attention_impl="blockdiag")
    scheduler = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(cfg.max_len, "cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dm = SyntheticDatamodule(tmp, max_len=cfg.max_len, num_samples=TRAIN_SAMPLES,
                                 batch_size=TRAIN_FLAGSHIP["batch"], fourier_transform=True,
                                 standardize=True)
        dm.prepare_data()
        dm.setup()
        n_steps = get_training_params(dm, TRAIN_EPOCHS)["num_training_steps"]
        fits = {}
        for log_every in (10_000, 1):
            for spc in (1, 16):
                model = ScoreModel(config=cfg, network=init_score_model(
                    cfg, torch.Generator().manual_seed(0)), scheduler=scheduler,
                    num_training_steps=n_steps)
                trainer = Trainer(max_epochs=TRAIN_EPOCHS, run_dir=tmp,
                                  run_id=f"spc{spc}-log{log_every}", seed=42,
                                  log_every_n_steps=log_every, steps_per_call=spc)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.fit(model, dm)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                records = [json.loads(line) for line in trainer.metrics_path.read_text().splitlines()]
                fits[log_every, spc] = (seconds, model, records, trainer.best_val_loss)
        for spc in (1, 16):
            out[f"spc{spc}_samples_per_s"] = TRAIN_EPOCHS * TRAIN_SAMPLES / fits[10_000, spc][0]
        (_, m1, r1, v1), (_, m16, r16, v16) = fits[1, 1], fits[1, 16]
        l1 = [r["train/loss"] for r in r1 if "train/loss" in r]
        l16 = [r["train/loss"] for r in r16 if "train/loss" in r]
        check(len(l1) == len(l16) == TRAIN_EPOCHS * len(dm.train_dataloader()),
              f"graphs train: {len(l1)} and {len(l16)} step losses")
        loss_rel = max(abs(a - b) / abs(a) for a, b in zip(l1, l16))
        params = [(a, b) for a, b in zip(m1.network.state_dict().values(),
                                          m16.network.state_dict().values())]
        param_rel = max(float(((b - a).abs() / a.abs().clamp_min(1e-30)).max()) for a, b in params)
        params_close = all(torch.allclose(b, a, rtol=2e-5, atol=2e-6) for a, b in params)
        out.update(step_loss_max_rel_diff=loss_rel, params_max_rel_diff=param_rel,
                   val_loss_rel_diff=abs(v16 - v1) / abs(v1), params_within_tol=params_close)
        check(loss_rel <= 2e-4, f"graphs train: per-step losses differ by {loss_rel:.3g}")
        check(out["val_loss_rel_diff"] <= 2e-4, f"graphs train: val loss {v16} vs {v1}")
        check(params_close, f"graphs train: parameters past rtol 2e-5 / atol 2e-6 "
              f"(max rel {param_rel:.3g})")

        # The steady step: 16 eager steps against one call of 16 replays.
        batches = [b for b in dm.train_dataloader()][:16]
        net = init_score_model(cfg, torch.Generator().manual_seed(0)).requires_grad_(True)
        opt = make_optimizer(net.parameters(), 1e-3, 1000)
        gen = torch.Generator(device="cuda").manual_seed(7)
        graphed = GraphedSteps(net, opt, scheduler, gen, False, 16)
        dev_batches = [torch.from_numpy(b).cuda() for b in batches]

        def eager():
            for b in dev_batches:
                train_step(net, opt, scheduler, b, gen)

        def replayed():
            graphed.run(batches)

        for label, fn in (("eager", eager), ("graphed", replayed)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            out[f"{label}_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / 48
            prof = device_breakdown(torch, f"graphs-train-{label}-16-steps", fn, reps=1, top=3,
                                    no_grad=False)
            out[f"{label}_busy_share"] = prof["busy_share"]
            out[f"{label}_calls_per_step"] = {k: v / 16 for k, v in prof["api_calls"].items()}
        inside = [launched for _, launched in graphed.runner.graphs.values()]
        out["graph_launches"] = dict(zip(("b1", "b2", "b3", "b4"), map(sum, zip(*inside))))
        check(all(out["graph_launches"][k] > 0 for k in ("b1", "b2", "b3")),
              f"graphs train: the step graph lacks a kernel: {out['graph_launches']}")
        out["resident"] = graphs_train_resident(torch, bda, cfg, scheduler, dm, tmp)
    print("graphs train", json.dumps(out), flush=True)
    return out


def graphs_train_resident(torch, bda, cfg, scheduler, dm, tmp) -> dict:
    """``Trainer(epochs_per_call=2)``, the device-resident epoch loop, over
    2 × 2 epochs: two calls, the first capturing its graph (2 epochs, the
    steps unrolled), the second a replay; each call's wall, the train
    samples/s of the replayed call (against the host loop's above), finite
    and falling losses, and B1, B2 counted through the replays."""
    from fdtpu_torch.models import ScoreModel, init_score_model
    from fdtpu_torch.train import Trainer, get_training_params
    from fdtpu_torch.train import trainer as trainer_mod

    epochs, per_call = 2 * TRAIN_EPOCHS, TRAIN_EPOCHS
    calls = []
    real_run = trainer_mod.ResidentEpochs.run

    def timed_run(self, first_epoch, n):
        t0 = time.perf_counter()
        result = real_run(self, first_epoch, n)
        calls.append(dict(epochs=n, seconds=time.perf_counter() - t0, graphs=len(self.graphs)))
        return result

    model = ScoreModel(config=cfg, network=init_score_model(cfg, torch.Generator().manual_seed(0)),
                       scheduler=scheduler,
                       num_training_steps=get_training_params(dm, epochs)["num_training_steps"])
    trainer = Trainer(max_epochs=epochs, run_dir=tmp, run_id="resident", seed=42,
                      epochs_per_call=per_call)
    trainer_mod.ResidentEpochs.run = timed_run
    torch.cuda.synchronize()
    bda.launches = bda.launches_bwd = bda.launches_trainable = 0
    try:
        t0 = time.perf_counter()
        trainer.fit(model, dm)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        trainer_mod.ResidentEpochs.run = real_run
    records = [json.loads(line) for line in trainer.metrics_path.read_text().splitlines()]
    val = [r["val/loss"] for r in records if "val/loss" in r]
    train = [r["train/loss_epoch"] for r in records if "train/loss_epoch" in r]
    n_train, n_val = len(dm.train_dataloader()), len(dm.val_dataloader())
    layers = cfg.num_layers
    out = dict(epochs=epochs, epochs_per_call=per_call, fit_seconds=seconds, calls=calls,
               samples_per_s_replayed_call=per_call * TRAIN_SAMPLES / calls[-1]["seconds"],
               capture_seconds=calls[0]["seconds"] - calls[-1]["seconds"],
               val_losses=val, train_losses=train, best_val_loss=trainer.best_val_loss,
               launches=(bda.launches, bda.launches_bwd, bda.launches_trainable))
    print("graphs train resident", json.dumps(out), flush=True)
    check(len(calls) == 2 and calls[0]["graphs"] == calls[1]["graphs"] == 1,
          f"graphs train resident: calls {calls}")
    check(all(math.isfinite(v) for v in val + train), "graphs train resident: a loss is not finite")
    check(train[-1] < train[0], f"graphs train resident: train loss not falling: {train}")
    check(out["launches"] == (layers * epochs * (n_train + n_val), layers * epochs * n_train,
                              layers * epochs * n_train),
          f"graphs train resident: launches {out['launches']} for {epochs} epochs of "
          f"{n_train} + {n_val} batches x {layers} layers")
    return out


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
                          sample_batch_size=SAMPLE_BATCH, seed=3, cache_kwargs=base,
                          batches_per_call=EVAL_BATCHES_PER_CALL)
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
                                   cache_kwargs=CACHE_KWARGS if use_cache else None,
                                   batches_per_call=EVAL_BATCHES_PER_CALL)
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


def _cli_counts(bda, mha) -> dict:
    return dict(b1=bda.launches, b2=bda.launches_bwd, b3=bda.launches_trainable, b4=mha.launches)


def _reset_counts(torch, bda, mha) -> None:
    torch.cuda.synchronize()
    bda.launches = bda.launches_bwd = bda.launches_trainable = mha.launches = 0


def cli_phase(torch, bda, mha) -> dict:
    """The port's entry points on the card, as a user types them: the train
    CLI on the synthetic data at the flagship's full width (trainer
    defaults, ``steps_per_call`` 16), resume through ``Trainer(resume=True)``
    held bitwise to the uninterrupted run, one epoch at
    ``accumulate_grad_batches=2``, the sample CLI uncached, at the score
    level's operating point and at the token level's ``token_full`` arm
    (``configs/sampler/default.yaml``: batches of 50, ``batches_per_call``
    2), and the MLP and LSTM backbones (one train-CLI epoch each, then a
    50-step uncached chain on their weights, CUDA against the CPU)."""
    import numpy as np

    from fdtpu_torch.cli import sample as sample_cli
    from fdtpu_torch.cli import train as train_cli
    from fdtpu_torch.sampling import sample_chain
    from fdtpu_torch.train import Trainer, get_best_checkpoint, get_training_params
    from fdtpu_torch.train import checkpoint as ckpt
    from fdtpu_torch.utils import builders, yaml_subset

    out = {}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        runs = tmp / "runs"
        common = ["datamodule=synthetic", f"datamodule.data_dir={tmp / 'data'}",
                  "fourier_transform=true", f"datamodule.max_len={TRAIN_FLAGSHIP['seq']}",
                  f"datamodule.num_samples={TRAIN_SAMPLES}", f"run_dir={runs}"]

        # Train: the flagship through the train CLI.
        _reset_counts(torch, bda, mha)
        t0 = time.perf_counter()
        runner = train_cli.main(common + [f"trainer.max_epochs={TRAIN_EPOCHS}", "+run_id=flagship"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _cli_counts(bda, mha)
        dm, model = runner.datamodule, runner.model
        layers = model.config.num_layers
        steps = TRAIN_EPOCHS * len(dm.train_dataloader())
        val_forwards = TRAIN_EPOCHS * len(dm.val_dataloader())
        records = [json.loads(line) for line in runner.trainer.metrics_path.read_text().splitlines()]
        epochs = [r for r in records if "val/loss" in r]
        line = dict(seconds=seconds, train_samples_per_s=TRAIN_EPOCHS * TRAIN_SAMPLES / seconds,
                    epoch_seconds=[r["epoch_time_s"] for r in epochs],
                    param_count=model.param_count(),
                    attention_impl=model.network.backbone[0].attention_impl,
                    losses=[(r["train/loss_epoch"], r["val/loss"]) for r in epochs],
                    checkpoints=sorted(p.name for p in (runner.trainer.run_dir / "checkpoints")
                                       .glob("*.ckpt")), **counts)
        print("cli train", json.dumps(line), flush=True)
        check(model.config.d_model == 72 and model.config.num_layers == 10
              and model.config.n_head == 12 and model.config.dim_feedforward == 2048,
              f"cli train: not the flagship width: {model.config}")
        check(line["attention_impl"] == "blockdiag", "cli train: auto did not pick B1 at Dh 6")
        check(len(epochs) == TRAIN_EPOCHS and all(
            math.isfinite(v) for pair in line["losses"] for v in pair), "cli train: losses")
        check(counts["b2"] == layers * steps and counts["b3"] == layers * steps,
              f"cli train: B2/B3 launches {counts} for {steps} steps x {layers} layers")
        check(counts["b1"] == layers * (steps + val_forwards),
              f"cli train: {counts['b1']} B1 launches for {steps} + {val_forwards} forwards")
        out["train"] = line

        # Sample: the three variants through the sample CLI, on that run.
        level_args = {
            "uncached": [],
            "score": ["use_cache=true"] + [f"+cache_kwargs.{k}={v}" for k, v in CACHE_KWARGS.items()],
            "token": ["use_cache=true"] + [f"+cache_kwargs.{k}={v}" for k, v in TOKEN_KWARGS.items()],
        }
        for name, extra in level_args.items():
            _reset_counts(torch, bda, mha)
            t0 = time.perf_counter()
            sampled = sample_cli.main([f"model_path={runs}", "model_id=latest",
                                       f"num_samples={NUM_SAMPLES}",
                                       f"num_diffusion_steps={NUM_STEPS}", *extra])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _cli_counts(bda, mha)
            sampler = sampled.sampler
            batches = NUM_SAMPLES // sampler.sample_batch_size
            n = batches * sampler.sample_batch_size
            stats = sampler.get_cache_stats()
            full = stats["full_steps"] if sampler.use_cache else NUM_STEPS * batches
            topk = stats["mixed_steps"] if name == "token" else 0
            results = yaml_subset.load(sampled.model_dir / "results.yaml")
            scalars = {k: v for k, v in results.items() if not isinstance(v, list)}
            samples = np.load(sampled.model_dir / "samples.npy")
            line = dict(seconds=seconds, samples_per_s=n / seconds, samples=n,
                        ms_per_step=1e3 * seconds / (NUM_STEPS * batches),
                        batches_per_call=sampler.batches_per_call, full_steps=full,
                        topk_steps=topk, steps_skipped_ratio=stats.get("steps_skipped_ratio", 0.0),
                        metrics=scalars, **counts)
            print(f"cli sample {name}", json.dumps(line), flush=True)
            check(sampled.model_dir == runner.trainer.run_dir, "cli sample: not the latest run")
            check(sampler.use_cache == (name != "uncached"), f"cli sample {name}: cache flag")
            check(samples.shape == (n, model.config.max_len, 1) and np.isfinite(samples).all(),
                  f"cli sample {name}: samples {samples.shape}")
            check(all(math.isfinite(v) for v in scalars.values()), f"cli sample {name}: metrics")
            check(counts["b1"] == layers * full,
                  f"cli sample {name}: {counts['b1']} B1 launches for {full} full forwards")
            check(counts["b4"] == layers * topk,
                  f"cli sample {name}: {counts['b4']} B4 launches for {topk} TOPK steps")
            if name == "token":
                check(topk > 0, "cli sample token: no TOPK step")
            out[f"sample_{name}"] = line

        # Resume on the card: one epoch, then a new trainer resumes to two.
        params = get_training_params(dm, TRAIN_EPOCHS)
        fits = {}
        t0 = time.perf_counter()
        for run_id, epochs_, resume in (("straight", TRAIN_EPOCHS, False), ("part", 1, False),
                                        ("part", TRAIN_EPOCHS, True)):
            trainer = Trainer(max_epochs=epochs_, run_dir=tmp / "resume", run_id=run_id,
                              seed=42, log_every_n_steps=1, resume=resume)
            fitted = trainer.fit(builders.build_model(runner.cfg, params, device="cuda"), dm)
            fits[run_id] = (fitted, trainer)
        torch.cuda.synchronize()
        (m_full, t_full), (m_part, t_part) = fits["straight"], fits["part"]

        def step_records(trainer):
            return [{k: v for k, v in json.loads(r).items() if k != "epoch_time_s"}
                    for r in trainer.metrics_path.read_text().splitlines()]

        s_full, meta_full = ckpt.load_train_state(t_full.run_dir)
        s_part, meta_part = ckpt.load_train_state(t_part.run_dir)
        same_state = all(torch.equal(a, b) for a, b in zip(
            [s_full["network"][k] for k in s_full["network"]] + s_full["optimizer"]["mu"]
            + s_full["optimizer"]["nu"] + [s_full["optimizer"]["updates"], s_full["generator"]],
            [s_part["network"][k] for k in s_full["network"]] + s_part["optimizer"]["mu"]
            + s_part["optimizer"]["nu"] + [s_part["optimizer"]["updates"], s_part["generator"]]))
        same_best = all(torch.equal(a, b) for a, b in zip(
            m_full.network.state_dict().values(), m_part.network.state_dict().values()))
        line = dict(seconds=time.perf_counter() - t0,
                    records_equal=step_records(t_full) == step_records(t_part),
                    step_losses=sum("train/loss" in r for r in step_records(t_full)),
                    state_bitwise=same_state, best_network_bitwise=same_best,
                    meta=(meta_full, meta_part))
        print("cli resume", json.dumps(line), flush=True)
        check(line["records_equal"] and line["step_losses"] == steps,
              "cli resume: losses or rates differ from the uninterrupted run")
        check(same_state and same_best and meta_full == meta_part,
              "cli resume: parameters, optimizer or generator differ from the uninterrupted run")
        out["resume"] = line

        # Accumulation: one CLI epoch at two micro-batches an update.
        _reset_counts(torch, bda, mha)
        t0 = time.perf_counter()
        acc = train_cli.main(common + ["trainer.max_epochs=1", "trainer.accumulate_grad_batches=2",
                                       "+run_id=accumulate"])
        torch.cuda.synchronize()
        counts = _cli_counts(bda, mha)
        steps1 = len(dm.train_dataloader())
        (epoch,) = [json.loads(r) for r in acc.trainer.metrics_path.read_text().splitlines()
                    if "val/loss" in r]
        line = dict(seconds=time.perf_counter() - t0,
                    num_training_steps=acc.model.num_training_steps,
                    train_loss=epoch["train/loss_epoch"], val_loss=epoch["val/loss"],
                    lr=epoch["lr"], **counts)
        print("cli accumulate", json.dumps(line), flush=True)
        check(acc.model.num_training_steps == steps1 // 2, "cli accumulate: schedule length")
        check(math.isfinite(line["train_loss"]) and math.isfinite(line["val_loss"]),
              "cli accumulate: loss not finite")
        check(counts["b2"] == layers * steps1, f"cli accumulate: {counts['b2']} B2 launches")
        out["accumulate"] = line

        # MLP and LSTM: a train-CLI epoch, then 50 steps CUDA against the CPU.
        for backbone in ("mlp", "lstm"):
            _reset_counts(torch, bda, mha)
            t0 = time.perf_counter()
            trained = train_cli.main([*common, f"score_model={backbone}", "trainer.max_epochs=1",
                                      f"run_dir={tmp / backbone}"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _cli_counts(bda, mha)
            best = get_best_checkpoint(trained.trainer.run_dir / "checkpoints")
            on_card = ckpt.load_checkpoint(best)
            on_cpu = ckpt.load_checkpoint(best, device="cpu")
            cfg = on_card.config
            g = torch.Generator(device="cuda").manual_seed(16)
            n_short, b_short = 50, 4
            z = torch.randn((n_short + 1, b_short, cfg.max_len, 1), generator=g, device="cuda")
            chains = {}
            for dev, m in (("cuda", on_card), ("cpu", on_cpu)):
                x0 = m.scheduler.prior_sampling((b_short, cfg.max_len, 1), noise=z[0].to(dev))
                t1 = time.perf_counter()
                x, _ = sample_chain(m.network, m.scheduler, x0, num_steps=n_short,
                                    step_noise=z[1:].to(dev))
                chains[dev] = (x.cpu(), time.perf_counter() - t1)
            rel = rel_err(chains["cuda"][0], chains["cpu"][0])
            line = dict(train_seconds=seconds,
                        train_samples_per_s=TRAIN_SAMPLES / seconds,
                        param_count=on_card.param_count(), d_model=cfg.d_model,
                        num_layers=cfg.num_layers, d_mlp=cfg.d_mlp,
                        chain_seconds={k: v[1] for k, v in chains.items()},
                        max_rel_err=rel, **counts)
            print(f"cli {backbone}", json.dumps(line), flush=True)
            check(cfg.backbone == backbone, f"cli {backbone}: built {cfg.backbone}")
            check(all(v == 0 for v in counts.values()), f"cli {backbone}: a kernel ran: {counts}")
            check(bool(torch.isfinite(chains["cuda"][0]).all()), f"cli {backbone}: not finite")
            # Tolerance: 1e-4 relative, as the transformer's uncached short
            # chain (slice phase): the card and the CPU sum in other orders.
            check(rel <= 1e-4, f"cli {backbone}: 50-step chain CUDA vs CPU rel err {rel:.3g}")
            out[backbone] = line
    return out


def _data_trees(tmp: Path) -> dict:
    """The NASDAQ, NASA (charge, discharge) and droughts raw trees at the
    JAX fixtures' sizes, and MIMIC from its ``.npy`` form, through
    ``prepare_data`` and ``setup``: their shapes and times."""
    import numpy as np

    from fdtpu_torch.data import datamodules as dms
    from fdtpu_torch.data import fixtures
    from fdtpu_torch.data.preprocessing import mimic_preprocess_frames

    out = {}
    trees = {
        "nasdaq": (fixtures.write_nasdaq_fixture, {}, dms.NASDAQDatamodule, {}, (252, 5)),
        "nasa-charge": (fixtures.write_nasa_fixture, {}, dms.NASADatamodule,
                        {"subdataset": "charge"}, (251, 4)),
        "nasa-discharge": (fixtures.write_nasa_fixture, {"kind": "discharge"},
                           dms.NASADatamodule, {"subdataset": "discharge"}, (134, 5)),
        "droughts": (fixtures.write_droughts_fixture, {}, dms.USDroughtsDatamodule, {},
                     (365, 7)),
    }
    for name, (write, wkw, cls, kw, shape) in trees.items():
        root = tmp / name
        t0 = time.perf_counter()
        write(root, **wkw)
        t1 = time.perf_counter()
        dm = cls(data_dir=root, batch_size=2, **kw)
        dm.prepare_data()
        dm.setup("fit")
        out[name] = dict(write_s=t1 - t0, prepare_setup_s=time.perf_counter() - t1,
                         train=list(dm.X_train.shape), test=list(dm.X_test.shape))
        check(dm.X_train.shape[1:] == shape and len(dm.X_train) + len(dm.X_test) > 0
              and np.isfinite(dm.X_train).all(), f"data {name}: {dm.X_train.shape}")
    # MIMIC: its frame pipeline on the fixture tables writes the .npy form.
    root = tmp / "mimic"
    (root / "mimiciii").mkdir(parents=True)
    t0 = time.perf_counter()
    mimic_preprocess_frames(*fixtures.mimic_fixture_tables(n_features=104, n_subjects=10),
                            root / "mimiciii", random_seed=42)
    dm = dms.MIMICIIIDatamodule(data_dir=root, batch_size=2)
    dm.prepare_data()
    dm.setup("fit")
    out["mimiciii"] = dict(seconds=time.perf_counter() - t0, train=list(dm.X_train.shape),
                           test=list(dm.X_test.shape))
    check(dm.X_train.shape[1:] == (24, 40) and np.isfinite(dm.X_train).all(),
          f"data mimiciii: {dm.X_train.shape}")
    return out


def _localization_on_card(torch, X) -> dict:
    """``localization_metrics`` and ``smooth_frequency`` on the card against
    the CPU over the whole ECG train set; the 1000 series
    ``subsample_localization`` keeps from each."""
    import numpy as np

    from fdtpu_torch.ops import localization_metrics, smooth_frequency

    x_cpu = torch.from_numpy(np.ascontiguousarray(X))
    x_gpu = x_cpu.cuda()
    t0 = time.perf_counter()
    cpu = localization_metrics(x_cpu)
    cpu_s = time.perf_counter() - t0
    localization_metrics(x_gpu)  # warm-up: cuFFT's plan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = localization_metrics(x_gpu)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    scores = [(a / b).cpu().numpy() for a, b in (cpu, gpu)]
    ranks = [np.argsort(s) for s in scores]
    kept = [set(r[:1000].tolist()) for r in ranks]
    order = np.sort(scores[0])
    smooth_cpu = smooth_frequency(x_cpu, ECG_SMOOTHER_WIDTH)
    smooth_gpu = smooth_frequency(x_gpu, ECG_SMOOTHER_WIDTH).cpu()
    out = dict(series=len(X), cpu_s=cpu_s, cuda_s=gpu_s,
               time_rel_err=rel_err(gpu[0].cpu(), cpu[0]),
               freq_rel_err=rel_err(gpu[1].cpu(), cpu[1]),
               score_max_rel_err=float(np.max(np.abs(scores[1] - scores[0]) / scores[0])),
               kept_differ=len(kept[0] - kept[1]), order_differ=int(
                   np.sum(ranks[0][:1000] != ranks[1][:1000])),
               score_gap_at_cut=float(order[1000] - order[999]),
               smooth_rel_err=rel_err(smooth_gpu, smooth_cpu))
    print("data localization", json.dumps(out), flush=True)
    # Tolerance: 1e-5 relative, a few float32 ulps over a 187-point FFT and
    # a 187-term product, summed in other orders on the two devices.
    check(out["time_rel_err"] <= 1e-5 and out["freq_rel_err"] <= 1e-5
          and out["smooth_rel_err"] <= 1e-5, f"data localization: CUDA vs CPU {out}")
    return out


def data_phase(torch, bda, mha) -> dict:
    """The real datasets and the cache-study CLIs on the card: the ECG tree
    written at MIT-BIH's published size and read by ``ECGDatamodule``; the
    other raw trees at the JAX fixtures' sizes; the localization pass CUDA
    against the CPU; the flagship trained 2 epochs on ECG through the train
    CLI (``subsample_localization``); the sample CLI on that run at
    ``configs/sample.yaml``'s defaults, uncached and at the score level; then
    ``ablation_cache`` and ``benchmark_cache`` on it at those defaults, from a
    temporary working directory."""
    import os

    import numpy as np

    from fdtpu_torch.cli import ablation_cache, benchmark_cache
    from fdtpu_torch.cli import sample as sample_cli
    from fdtpu_torch.cli import train as train_cli
    from fdtpu_torch.data import ECGDatamodule, fixtures
    from fdtpu_torch.utils import yaml_subset

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        data = tmp / "data"
        t0 = time.perf_counter()
        fixtures.write_ecg_fixture(data, n_train=ECG_ROWS[0], n_test=ECG_ROWS[1])
        t1 = time.perf_counter()
        dm = ECGDatamodule(data_dir=data, batch_size=64)
        dm.prepare_data()
        t2 = time.perf_counter()
        dm.setup("fit")
        t3 = time.perf_counter()
        line = dict(rows=list(ECG_ROWS), write_s=t1 - t0, prepare_s=t2 - t1, setup_s=t3 - t2,
                    bytes=sum(p.stat().st_size for p in (data / "ecg").glob("*.csv")),
                    train=list(dm.X_train.shape), test=list(dm.X_test.shape))
        print("data ecg", json.dumps(line), flush=True)
        check(dm.X_train.shape == (ECG_ROWS[0] - 1, 187, 1)
              and dm.X_test.shape == (ECG_ROWS[1] - 1, 187, 1),
              f"data ecg: not the header-dropped MIT-BIH shapes: {line}")
        check(dm.y_train.dtype == np.int64 and set(np.unique(dm.y_train)) <= set(range(5))
              and np.isfinite(dm.X_train).all(), "data ecg: labels or values")
        out["ecg"] = line
        out["trees"] = _data_trees(tmp / "trees")
        print("data trees", json.dumps(out["trees"]), flush=True)
        out["localization"] = _localization_on_card(torch, dm.X_train)
        del dm

        # Train the flagship on ECG through the train CLI.
        runs = tmp / "runs"
        _reset_counts(torch, bda, mha)
        t0 = time.perf_counter()
        runner = train_cli.main(["datamodule=ecg", f"datamodule.data_dir={data}",
                                 "fourier_transform=true",
                                 "datamodule.subsample_localization=true",
                                 f"trainer.max_epochs={TRAIN_EPOCHS}", f"run_dir={runs}",
                                 "+run_id=ecg"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _cli_counts(bda, mha)
        model, tdm = runner.model, runner.datamodule
        layers = model.config.num_layers
        steps = TRAIN_EPOCHS * len(tdm.train_dataloader())
        val_forwards = TRAIN_EPOCHS * len(tdm.val_dataloader())
        records = [json.loads(r) for r in runner.trainer.metrics_path.read_text().splitlines()]
        epochs = [r for r in records if "val/loss" in r]
        line = dict(seconds=seconds, train_samples=len(tdm.X_train),
                    train_samples_per_s=TRAIN_EPOCHS * len(tdm.X_train) / seconds,
                    epoch_seconds=[r["epoch_time_s"] for r in epochs],
                    losses=[(r["train/loss_epoch"], r["val/loss"]) for r in epochs], **counts)
        print("data train", json.dumps(line), flush=True)
        check(model.config.d_model == 72 and model.config.num_layers == 10
              and model.config.max_len == 187 and len(tdm.X_train) == 1000,
              f"data train: not the flagship on the 1000 localized ECG beats: {model.config}")
        check(len(epochs) == TRAIN_EPOCHS and all(
            math.isfinite(v) for pair in line["losses"] for v in pair), "data train: losses")
        check(counts["b2"] == layers * steps and counts["b3"] == layers * steps
              and counts["b1"] == layers * (steps + val_forwards),
              f"data train: launches {counts} for {steps} steps, {val_forwards} val forwards")
        out["train"] = line

        # Sample from that run at configs/sample.yaml's defaults.
        for name, extra in (("uncached", []), ("score", ["use_cache=true"] + [
                f"+cache_kwargs.{k}={v}" for k, v in CACHE_KWARGS.items()])):
            _reset_counts(torch, bda, mha)
            t0 = time.perf_counter()
            sampled = sample_cli.main([f"model_path={runs}", "model_id=latest", *extra])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _cli_counts(bda, mha)
            sampler = sampled.sampler
            stats = sampler.get_cache_stats()
            n = int(sampled.cfg["num_samples"])
            steps_run = int(sampled.cfg["num_diffusion_steps"]) * (n // sampler.sample_batch_size)
            full = stats["full_steps"] if sampler.use_cache else steps_run
            samples = np.load(sampled.model_dir / "samples.npy")
            results = yaml_subset.load(sampled.model_dir / "results.yaml")
            scalars = {k: v for k, v in results.items() if not isinstance(v, list)}
            line = dict(seconds=seconds, samples=len(samples), steps=steps_run, full_steps=full,
                        batches_per_call=sampler.batches_per_call, metrics=scalars, **counts)
            print(f"data sample {name}", json.dumps(line), flush=True)
            check(samples.shape == (n, 187, 1) and np.isfinite(samples).all()
                  and all(math.isfinite(v) for v in scalars.values()),
                  f"data sample {name}: samples {samples.shape} or metrics")
            check(counts["b1"] == layers * full,
                  f"data sample {name}: {counts['b1']} B1 launches for {full} full forwards")
            out[f"sample_{name}"] = line
        # The cache CLIs' samplers run as many steps a call (the same defaults).
        default_steps = out["sample_uncached"]["steps"]

        # The cache-study CLIs, from a working directory of their own.
        work = tmp / "work"
        work.mkdir()
        here = Path.cwd()
        os.chdir(work)
        try:
            args = [f"model_path={runs}", "model_id=latest"]
            _reset_counts(torch, bda, mha)
            t0 = time.perf_counter()
            results = ablation_cache.main(args)
            torch.cuda.synchronize()
            line = dict(seconds=time.perf_counter() - t0, arms=len(results),
                        **_cli_counts(bda, mha))
            check(list(results) == [name for name, _ in ablation_cache.arms()],
                  f"data ablation: arms {list(results)}")
            for name, entry in results.items():
                stats = entry.get("cache_stats") or {}
                check(all(math.isfinite(v) for v in entry.values() if isinstance(v, float))
                      and all(math.isfinite(v) for v in stats.values()),
                      f"data ablation {name}: {entry}")
                check(not stats or stats["full_steps"] + stats["mixed_steps"]
                      + stats["cached_steps"] == default_steps,
                      f"data ablation {name}: stats count other steps: {stats}")
            line["table"] = {name: [e["time_s"], e.get("speedup"), e.get("sw_vs_baseline"),
                                    (e.get("cache_stats") or {}).get("steps_skipped_ratio")]
                             for name, e in results.items()}
            print("data ablation", json.dumps(line), flush=True)
            check(line["b1"] > 0 and line["b4"] > 0, f"data ablation: launches {line}")
            out["ablation"] = line

            _reset_counts(torch, bda, mha)
            t0 = time.perf_counter()
            rows = benchmark_cache.main(args + ["run_ablations=false"])
            torch.cuda.synchronize()
            line = dict(seconds=time.perf_counter() - t0, arms=len(rows), **_cli_counts(bda, mha))
            expected = (["baseline", "baseline_self(noise floor)"]
                        + [name for name, _ in benchmark_cache.HEADLINE])
            check([row["method"] for row in rows] == expected,
                  f"data benchmark: arms {[row['method'] for row in rows]}")
            for row in rows:
                check(all(math.isfinite(v) for v in row.values() if isinstance(v, float)),
                      f"data benchmark {row['method']}: {row}")
                check("cache_full_steps" not in row or row["cache_full_steps"]
                      + row["cache_mixed_steps"] + row["cache_cached_steps"] == default_steps,
                      f"data benchmark {row['method']}: stats count other steps")
            check((work / "outputs/cache_benchmark/benchmark_results.csv").exists()
                  and (work / "ablation_results/ablation_sweep.csv").exists(),
                  "data: a CLI's table is missing")
            line["table"] = {row["method"]: [row["time_s"], row.get("speedup"),
                                              row.get("sw_vs_baseline"),
                                              row.get("cache_steps_skipped_ratio")]
                             for row in rows}
            print("data benchmark", json.dumps(line), flush=True)
            check(line["b1"] > 0 and line["b4"] > 0, f"data benchmark: launches {line}")
            out["benchmark"] = line
        finally:
            os.chdir(here)
    print(f"data phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# The Table-2 harness's ECG run on the card: the flagship at full width, 2
# epochs on the 1000 most time-localized beats (as the data phase's train
# CLI), 256 samples at T = 1000 in batches of 128, both domains.
TABLE2_ARGS = ["--epochs", str(TRAIN_EPOCHS), "--num-samples", str(NUM_SAMPLES),
               "--steps", str(NUM_STEPS), "--sample-batch", str(SAMPLE_BATCH),
               "--override", "datamodule.subsample_localization=true"]
# What tests/test_table2_schema.py's assert_table2_schema requires of a JSON.
TABLE2_PAPER_DATASETS = ("droughts", "ecg", "nasa_charge", "nasa_discharge", "nasdaq")


def table2_schema_errors(payload: dict, dataset: str, domains=("frequency",)) -> list[str]:
    """The ways ``payload`` misses the Table-2 schema (none if it holds)."""
    errors = []
    proto = payload.get("protocol", {})
    errors += [f"protocol lacks {k}" for k in ("epochs", "num_samples", "steps", "seed",
                                                "cached_kwargs") if k not in proto]
    if payload.get("dataset") != dataset:
        errors.append(f"dataset {payload.get('dataset')!r}")
    if proto.get("fixture_data") and "warning" not in payload:
        errors.append("fixture data without a warning")
    for domain in domains:
        arms = payload.get("domains", {}).get(domain, {}).get("arms", {})
        for arm in ("baseline", "cached"):
            row = arms.get(arm, {})
            if not (isinstance(row.get("time_sliced_wasserstein_mean"), float)
                    and isinstance(row.get("time_sliced_wasserstein_std"), float)
                    and row.get("sample_time_s", -1) >= 0):
                errors.append(f"{domain} {arm} row {sorted(row)}")
        if not arms.get("cached", {}).get("cache_stats", {}).get("steps_skipped_ratio", -1) >= 0:
            errors.append(f"{domain} cached arm lacks steps_skipped_ratio")
    summary = payload.get("summary", {})
    if None in (summary.get("fdtpu_baseline_sw", [None])[0],
                summary.get("fdtpu_cached_sw", [None])[0]):
        errors.append("summary lacks the SW pair")
    ref = payload.get("reference_table2")
    if dataset in TABLE2_PAPER_DATASETS:
        if ref is None or len(ref["baseline_sw"]) != 2 or summary.get("reference") != ref:
            errors.append("reference row")
    elif ref is not None:
        errors.append("a reference row for a dataset outside the paper's table")
    return errors


def table2_phase(torch, bda, mha) -> dict:
    """The port's Table-2 harness (``fdtpu_torch.cli.validate_real_data``) in
    this process: ECG at MIT-BIH's size (the data phase's tree, written anew)
    through both domains at the flagship's full width, its launches counted
    a train and a sample call (B1 = layers × full forwards, B2 = B3 = layers
    × train steps), the JSON held to the Table-2 schema; then ``all
    --fixture --smoke --domains frequency`` over the seven fixture trees;
    then the viz tables on those run directories."""
    import os

    from fdtpu_torch.cli import sample as sample_cli
    from fdtpu_torch.cli import train as train_cli
    from fdtpu_torch.cli import validate_real_data as harness
    from fdtpu_torch.data import fixtures

    t_phase = time.perf_counter()
    calls = []
    real_train, real_sample = train_cli.TrainingRunner.train, sample_cli.SamplingRunner.sample

    def counted(real, kind):
        def call(self):
            _reset_counts(torch, bda, mha)
            t0 = time.perf_counter()
            out = real(self)
            torch.cuda.synchronize()
            calls.append((kind, self, time.perf_counter() - t0, _cli_counts(bda, mha)))
            return out
        return call

    out = {}
    here = Path.cwd()
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        fixtures.write_ecg_fixture(tmp / "data", n_train=ECG_ROWS[0], n_test=ECG_ROWS[1])
        train_cli.TrainingRunner.train = counted(real_train, "train")
        sample_cli.SamplingRunner.sample = counted(real_sample, "sample")
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            code = harness.main(["ecg", "--data-dir", str(tmp / "data"),
                                 "--run-dir", str(tmp / "runs"),
                                 "--out", str(tmp / "table2_ecg_full.json"), *TABLE2_ARGS])
            ecg_seconds = time.perf_counter() - t0
            check(code == 0, f"table2 ecg: exit code {code}")
            ecg_calls, calls[:] = list(calls), []
            t0 = time.perf_counter()
            code = harness.main(["all", "--fixture", "--smoke", "--domains", "frequency",
                                 "--data-dir", str(tmp / "fixtures"),
                                 "--run-dir", str(tmp / "fixture_runs")])
            fixture_seconds = time.perf_counter() - t0
            check(code == 0, f"table2 fixtures: exit code {code}")
        finally:
            os.chdir(here)
            train_cli.TrainingRunner.train, sample_cli.SamplingRunner.sample = (
                real_train, real_sample)
        payload = json.loads((tmp / "table2_ecg_full.json").read_text())
        errors = table2_schema_errors(payload, "ecg", domains=("frequency", "time"))
        check(not errors, f"table2 ecg: not the Table-2 schema: {errors}")
        totals = dict(b1=0, b2=0, b3=0, b4=0)
        for i, domain in enumerate(("frequency", "time")):
            (_, trainer, train_s, tc), *arms = ecg_calls[3 * i: 3 * i + 3]
            entry = payload["domains"][domain]
            layers = trainer.model.config.num_layers
            steps = TRAIN_EPOCHS * len(trainer.datamodule.train_dataloader())
            val = TRAIN_EPOCHS * len(trainer.datamodule.val_dataloader())
            check(trainer.model.config.d_model == 72 and layers == 10
                  and len(trainer.datamodule.X_train) == 1000,
                  f"table2 {domain}: not the flagship on the 1000 localized beats")
            check(tc["b2"] == tc["b3"] == layers * steps and tc["b1"] == layers * (steps + val),
                  f"table2 {domain} train: launches {tc} for {steps} steps, {val} val forwards")
            line = dict(train_s=entry["train_time_s"], train_call_s=train_s,
                        train_samples=len(trainer.datamodule.X_train), train_steps=steps,
                        val_forwards=val, best_val_loss=entry["best_val_loss"], arms={})
            counts = dict(tc)
            for (_, runner, sample_s, sc), arm in zip(arms, ("baseline", "cached")):
                row = entry["arms"][arm]
                stats = runner.sampler.get_cache_stats() if runner.sampler.use_cache else {}
                full = stats.get("full_steps", NUM_STEPS * (NUM_SAMPLES // SAMPLE_BATCH))
                check(sc["b1"] == layers * full and sc["b2"] == 0,
                      f"table2 {domain} {arm}: {sc} for {full} full forwards")
                check(math.isfinite(row["time_sliced_wasserstein_mean"]),
                      f"table2 {domain} {arm}: SW {row['time_sliced_wasserstein_mean']}")
                line["arms"][arm] = dict(
                    sample_s=row["sample_time_s"], sample_call_s=sample_s, full_steps=full,
                    steps_skipped_ratio=stats.get("steps_skipped_ratio", 0.0),
                    time_sw_mean=row["time_sliced_wasserstein_mean"],
                    time_sw_std=row["time_sliced_wasserstein_std"], b1=sc["b1"])
                counts = {k: counts[k] + sc[k] for k in counts}
            line.update(counts)
            totals = {k: totals[k] + counts[k] for k in totals}
            print(f"table2 {domain}", json.dumps(line), flush=True)
            out[domain] = line
        out["summary"] = payload["summary"]
        out["protocol"] = payload["protocol"]
        out["ecg_seconds"] = ecg_seconds
        fixture_counts = {k: sum(c[3][k] for c in calls) for k in totals}
        fixture_line = dict(seconds=fixture_seconds, **fixture_counts, summaries={})
        datasets = sorted(harness.DATASETS)
        for ds in datasets:
            payload = json.loads((tmp / f"outputs/table2_torch/table2_{ds}.json").read_text())
            errors = table2_schema_errors(payload, ds)
            check(not errors, f"table2 fixture {ds}: not the Table-2 schema: {errors}")
            fixture_line["summaries"][ds] = dict(summary=payload["summary"],
                                                 fixture_form=payload["protocol"].get(
                                                     "fixture_form"))
        check(fixture_counts["b1"] > 0 and fixture_counts["b2"] > 0,
              f"table2 fixtures: launches {fixture_counts}")
        print("table2 fixtures", json.dumps(fixture_line), flush=True)
        out["fixtures"] = fixture_line
        out["counts"] = {k: totals[k] + fixture_counts[k] for k in totals}
        out["viz"] = viz_tables(torch, tmp, datasets)
    print(f"table2 phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def viz_tables(torch, tmp: Path, datasets: list[str]) -> dict:
    """``fdtpu_torch.viz``'s tables on the Table-2 run directories (the ECG
    pair and the seven fixture runs): per-distance rows, the summary tables
    (CSV and LaTeX), the LaTeX run table and the spectral profiles, each file
    checked written; then ``spectral_interpretation.process_dataset`` on the
    MIT-BIH-size ECG datamodule with the localization on the card."""
    import numpy as np

    from fdtpu_torch import viz
    from fdtpu_torch.data import ECGDatamodule

    line = {}
    for name, runs, run_ids in (
        ("ecg", tmp / "runs", [f"table2_ecg_{d}" for d in ("frequency", "time")]),
        ("fixtures", tmp / "fixture_runs", [f"table2_{ds}_frequency"
                                            for ds in datasets]),
    ):
        out = tmp / "viz" / name
        t0 = time.perf_counter()
        metrics, baselines = viz.process_run_metrics(run_ids, runs, out)
        tables = {metric: viz.create_summary_table(metrics, metric, out / "tables")
                  for metric in dict.fromkeys(r["Metric"] for r in metrics)}
        latex = viz.results_to_latex(viz.process_results(runs))
        spectral = viz.process_spectral_analysis(run_ids, runs, out)
        seconds = time.perf_counter() - t0
        written = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
        want = ["baselines.csv", "metrics.csv", "spectral_density.csv"] + [
            f"tables/{m.lower().replace(' ', '_')}{suffix}" for m in tables
            for suffix in ("_summary.csv", ".tex")]
        check(sorted(want) == written, f"viz {name}: wrote {written}, not {sorted(want)}")
        check(all(len(g.rows) > 0 and g.values.size > 0 for g in tables.values())
              and latex.startswith("\\begin{tabular}") and spectral,
              f"viz {name}: empty tables")
        line[name] = dict(seconds=seconds, metric_rows=len(metrics),
                          baseline_rows=len(baselines), spectral_rows=len(spectral),
                          summary_rows={m: len(g.rows) for m, g in tables.items()},
                          files=len(written))
    t0 = time.perf_counter()
    dm = ECGDatamodule(data_dir=tmp / "data")
    spectral, temporal, loc, joint = viz.process_dataset("ECG", dm, device="cuda")
    line["process_dataset"] = dict(seconds=time.perf_counter() - t0, series=len(dm.X_train),
                                   frequencies=len(spectral["Normalized Frequency"]),
                                   localization_rows=len(loc["Delocalization"]))
    check(len(dm.X_train) == ECG_ROWS[0] - 1
          and len(loc["Delocalization"]) == 2 * len(dm.X_train)
          and all(bool(np.isfinite(v).all()) for v in (spectral["Normalized Spectral Density"],
                                                       temporal["Normalized Energy"],
                                                       joint["Delocalization Time"])),
          f"viz process_dataset: {line['process_dataset']}")
    print("viz", json.dumps(line), flush=True)
    return line


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
        from fdtpu_torch.utils import conditional
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
    build.build([bda.SOURCE, bda.SOURCE_BWD, mha.SOURCE, conditional.SOURCE], verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    if sys.argv[1:] == ["--step-times"]:
        step_times(torch)
        return 0
    if sys.argv[1:] == ["--export-window"]:
        export_window(torch)
        return 0

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    kernel_results = timed("kernels", kernel_phase, torch, bda)
    mha_results = timed("kernel_mha", mha_kernel_phase, torch, mha)
    bwd_results = timed("kernel_bwd", bwd_kernel_phase, torch, bda)
    trainable = timed("trainable", trainable_phase, torch, bda)
    timed("head_dim_sweep", head_dim_sweep, torch, bda, mha)
    timed("slice", slice_phase, torch, bda)
    levels = timed("levels", levels_phase, torch, bda, mha)
    freq_chains = timed("freq", freq_options_phase, torch, bda, mha)
    graphed, first_batches = timed("graphs", graphs_phase, torch, bda, mha)
    exported = timed("export", export_phase, torch, bda, mha, first_batches)
    train, trained, dm = timed("train", train_phase, torch, bda)
    evaluation = timed("eval", eval_phase, torch, bda, trained, dm)
    cli = timed("cli", cli_phase, torch, bda, mha)
    data = timed("data", data_phase, torch, bda, mha)
    table2 = timed("table2", table2_phase, torch, bda, mha)
    cli_runs = [cli["train"], cli["accumulate"]] + [cli[f"sample_{name}"]
                                                    for name in ("uncached", "score", "token")]
    cli_runs += [data[name] for name in ("train", "sample_uncached", "sample_score",
                                         "ablation", "benchmark")]
    cli_runs.append(table2["counts"])
    level_chains = [c for c in levels.values() if isinstance(c, dict)]
    level_chains += list(freq_chains.values())
    level_chains += [run for name, line in graphed.items() if name != "train"
                     for run in (line["eager"], line["resident"])]
    level_chains += list(exported.values())

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
                      train["launches"]
                      + sum(c["launches_b1"] for c in level_chains) + evaluation["launches"]
                      + sum(c["b1"] for c in cli_runs), kernel_results),
        kernel_record("fused_mha", "fdtpu_torch/kernels/csrc/fused_attention.cu",
                      "fdtpu/kernels/attention.py:80",
                      sum(c["launches_b4"] for c in level_chains) + sum(c["b4"] for c in cli_runs),
                      mha_results),
        kernel_record("blockdiag_mha_bwd", "fdtpu_torch/kernels/csrc/blockdiag_attention_bwd.cu",
                      "fdtpu/kernels/blockdiag_attention.py:373",
                      train["launches_bwd"] + sum(c["b2"] for c in cli_runs), bwd_results),
        {"name": "blockdiag_mha_trainable", "route": "autograd.Function",
         "source": "fdtpu_torch/kernels/blockdiag_attention.py",
         "replaces": "fdtpu/kernels/blockdiag_attention.py:410",
         "launches": train["launches_trainable"] + sum(c["b3"] for c in cli_runs),
         "max_abs_err": trainable["max_abs_err"],
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
