"""Export CLI of the port (port of ``cli/export_sampler.py``).

Usage:
    python -m fdtpu_torch.cli.export_sampler model_id=<run_id|latest> \\
        [sample_batch_size=128 num_diffusion_steps=1000 use_cache=true \\
         +cache_kwargs.level=score out=/path/sampler.pt2]

Composes ``configs/export.yaml``, restores the run's best checkpoint, builds
the (optionally E²-CRF-cached) sampler and exports its whole reverse chain,
weights included, with ``fdtpu_torch.serve.export_sampler``: the program to
``<run_dir>/export/sampler.pt2`` unless ``out=`` is given, its metadata to
``<out>.json``, and the metadata as one JSON line on stdout.  The program
runs with torch and ``fdtpu_torch.kernels`` only::

    from fdtpu_torch.serve import load_exported
    fn = load_exported("sampler.pt2")
    samples = fn(torch.Generator("cuda").manual_seed(0))

It exports on the CUDA card, where the program then runs; ``+device=cpu``
exports for the CPU.
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path
from typing import Any, Optional

from fdtpu_torch.sampling import DiffusionSampler
from fdtpu_torch.serve import export_sampler
from fdtpu_torch.train import get_best_checkpoint, load_checkpoint
from fdtpu_torch.utils.builders import resolve_model_dir
from fdtpu_torch.utils.config import CONFIG_DIR, compose_config
from fdtpu_torch.utils.device import resolve_device


def main(argv: Optional[list[str]] = None) -> dict[str, Any]:
    """Compose ``configs/export.yaml`` with ``argv`` (default
    ``sys.argv[1:]``), export, and return the printed metadata."""
    logging.basicConfig(level=logging.INFO, format="%(message)s", force=True)
    cfg = compose_config(CONFIG_DIR, "export", sys.argv[1:] if argv is None else list(argv))
    device = resolve_device(cfg.get("device"))
    model_dir = resolve_model_dir(cfg["model_path"], cfg["model_id"])
    ckpt = get_best_checkpoint(model_dir / "checkpoints")
    logging.info("Exporting checkpoint %s", ckpt)

    # Hardware choices, not part of the weights.
    overrides = {k: cfg[k] for k in ("attention_impl", "compute_dtype") if cfg.get(k)}
    model = load_checkpoint(ckpt, device=device, **overrides)

    sampler = DiffusionSampler(
        model,
        sample_batch_size=int(cfg["sample_batch_size"]),
        use_cache=bool(cfg.get("use_cache", False)),
        cache_kwargs=dict(cfg.get("cache_kwargs") or {}),
    )
    out = Path(cfg["out"]) if cfg.get("out") else model_dir / "export" / "sampler.pt2"
    platforms = cfg.get("platforms")
    meta = export_sampler(
        sampler,
        num_diffusion_steps=int(cfg["num_diffusion_steps"]),
        path=out,
        platforms=list(platforms) if platforms else None,
    )
    logging.info("wrote %s (%d bytes)", out, out.stat().st_size)
    line = {"path": str(out), **meta}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
