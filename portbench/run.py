"""Run one cell of the benchmark of ``fdtpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for.  The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
traffic is ``portbench/workloads/<cell>.json`` (whose ``entry`` names the
module under ``portbench/entries/`` that drives it), its configuration the
file the manifest names.  ``--trace 0`` prints the cell's end-to-end
metrics; ``--trace 1`` runs the same window, then a traced segment, and prints its
per-layer metrics, each read by ``portbench/metrics/<metric>.py`` (or by the
reader of the name's part before its first dot).  Either way the outputs of the window are
then held to the plain reference under ``portbench/reference/``, and the
last line of standard output is the result."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import common  # noqa: E402


def log(text: str) -> None:
    print(f"portbench: {text}", file=sys.stderr, flush=True)


def card() -> dict:
    """The card's name and power limit (``nvidia-smi``)."""
    import torch

    info = {"kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        info["power_limit"] = out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "unknown"
    return info


def run_cell(name: str, cell: dict, traffic: dict, config: dict, seed: int, seconds: float,
             trace: bool, device, bench: dict, control: bool = False) -> dict:
    """Set up, measure, optionally trace, and check one run of a cell;
    returns what the result line holds (and ``numbers``, the compared
    values).  ``control``: also the control's numbers (the reference in
    TF32 in the program's place)."""
    import torch

    from portbench import trace as tr

    device = torch.device(device)
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    run = entry.Cell(cell, traffic, config, seed, device)
    common.stamp("imports")
    try:
        run.setup()
        setup_s = time.perf_counter() - T0
        log(f"set-up {setup_s:.3f} s")
        window = run.window(seconds)
        log(f"window {window}")
        found = common.forbidden_loaded()
        if found:
            raise common.BenchError(f"the run loaded JAX or the JAX package: {found}")
        obs = {"config": config, "traffic": traffic, "window": window}
        extra = {}
        if trace:
            obs["traced"] = run.traced(lambda fn: tr.profile(fn, device))
            prof = obs["traced"].pop("profiler")
            if device.type == "cuda":
                obs["trace"] = tr.summarize(prof)
                _complete(obs)
                extra = {"busy_s": obs["trace"]["busy_s"], "window_s": obs["trace"]["window_s"]}
            log(f"traced segment read: busy {extra.get('busy_s')} s of {extra.get('window_s')} s")
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        run.free()
        t_check = time.perf_counter()
        numbers = run.check()
        log(f"check {time.perf_counter() - t_check:.3f} s: {numbers}")
        ctl = run.check(control=True) if control else None
    finally:
        if hasattr(run, "close"):
            run.close()
    ok, checks = common.check_numbers(numbers, traffic["limits"])
    if trace:
        metrics = {}
        for m in common.metrics_of(name, "per_layer", bench):
            value = common.load_reader(m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = run.end_to_end(setup_s)
    attempted, failed = run.attempted()
    info = card() if device.type == "cuda" else {"kind": "cpu", "power_limit": "none"}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": info["kind"],
           "count": cell["chips"], "memory_peak_bytes": peak, **extra}
    breakdown = ({"device_ops": obs["trace"]["device_ops"],
                  "idle_gaps": obs["trace"]["idle_gaps"]} if "trace" in obs else None)
    return dict(correct=ok, attempted=attempted, failed=failed, metrics=metrics, device=dev,
                checks=checks, breakdown=breakdown, numbers=numbers, control=ctl,
                power_limit=info["power_limit"], window=window)


def _complete(obs: dict) -> None:
    """Refuse a trace that missed a launch the program's counters report."""
    from portbench.trace import count

    for kernel, counted in obs["traced"]["counted"].items():
        seen, _ = count(obs["trace"]["kernels"], kernel)
        expected = obs["traced"].get("expected", {}).get(kernel, counted)
        if seen != counted or counted != expected:
            raise common.BenchError(
                f"the trace saw {seen} launches of {kernel}, the program counted {counted} "
                f"and the segment's shapes need {expected}: the trace is incomplete")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    common.set_cache_dirs()
    try:
        bench = common.manifest()
        cell, traffic, config = common.cell_files(args.workload, bench)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise common.BenchError(
                f"cell {args.workload} needs {cell['chips']} CUDA card(s); this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        r = run_cell(args.workload, cell, traffic, config, args.seed, args.seconds,
                     bool(args.trace), "cuda", bench)
        found = common.forbidden_loaded()
        if found:
            raise common.BenchError(f"the run loaded JAX or the JAX package: {found}")
    except common.BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    print(f"card: {r['device']['kind']}, power limit {r['power_limit']}", file=sys.stderr)
    common.print_result(r["correct"], r["attempted"], r["failed"], r["metrics"], r["device"],
                        r["checks"], r["breakdown"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
