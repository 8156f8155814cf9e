#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fdtpu_torch``) on one NVIDIA GPU and check it.

Usage, from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; builds the CUDA kernels from ``fdtpu_torch/kernels/csrc``.
2. Kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the serving path's shapes, with its time, the plain version's
   time, a one-call PyTorch yardstick (``library_ms``, timed only) and the
   least time the card could take (``bound_ms``).
3. Slice: the flagship score model (d_model 72, 10 layers, 12 heads, FFN
   2048, 187 frequency tokens; random weights from a seed) on CUDA with the
   block-diagonal attention kernel: ``score_apply`` against the einsum path
   and against the CPU; then ``DiffusionSampler`` uncached and at the
   score-level E²-CRF operating point, T = 1000 steps, 256 samples in
   batches of 128; kernel launches counted on each chain; samples
   de-standardized with the synthetic train-set statistics and taken back to
   the time domain.

Float32 matmuls run in full float32 (TF32 off for matmuls and cuDNN).  The
line before the last is one JSON object with a record per kernel; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
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
FLAGSHIP = dict(batch=128, seq=187, n_head=12, head_dim=6)
NUM_STEPS = 1000
NUM_SAMPLES = 256
SAMPLE_BATCH = 128


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


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


def attention_bound_ms(batch, seq, n_head, head_dim, itemsize, bf16) -> tuple[float, str]:
    """Least time for one blockdiag_mha call: q, k, v read once and out
    written once, against 4·B·H·T²·Dh score/value FLOPs at the input type's
    peak plus B·H·T² float32 exps at the float32 peak."""
    n_bytes = 4 * batch * seq * n_head * head_dim * itemsize
    flops = 4 * batch * n_head * seq * seq * head_dim
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


def device_breakdown(torch, label: str, fn, reps: int = 3, top: int = 8) -> None:
    """Device time of ``fn`` by kernel (torch.profiler) and the share of its
    wall time (measured under the profiler) that the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
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
        if dev_us > 0 and "cuda" in str(getattr(e, "device_type", "")).lower():
            rows.append((dev_us / 1e3 / reps, e.count // reps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f"breakdown {label}: wall {wall_ms:.4f} ms, the profiler saw no device time")
        return
    print(f"breakdown {label}: wall {wall_ms:.4f} ms, device busy {busy:.4f} ms "
          f"({100 * busy / wall_ms:.1f}%)", flush=True)
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
    rel = float((x_gpu.cpu() - x_ref).abs().max() / x_ref.abs().max())
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from fdtpu_torch.kernels import blockdiag_attention as bda
        from fdtpu_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: fdtpu_torch is not importable here ({exc})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    build.build([bda.SOURCE], verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    kernel_results = kernel_phase(torch, bda)
    chains = slice_phase(torch, bda)

    flagship = kernel_results[0]
    launches = sum(c["launches"] for c in chains.values())
    record = {
        "name": "blockdiag_mha",
        "route": "cuda",
        "source": "fdtpu_torch/kernels/csrc/blockdiag_attention.cu",
        "replaces": "fdtpu/kernels/blockdiag_attention.py:221",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_results if r["dtype"] == "float32"),
        "ms": flagship["kernel_ms"],
        "plain_ms": flagship["plain_ms"],
        "bound_ms": flagship["bound_ms"],
        "bound_by": flagship["bound_by"],
        "library_ms": flagship["library_ms"],
    }
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
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
