"""Optional Weights & Biases logging (port of ``fdtpu/utils/wandb.py``).

``wandb`` is imported only when a config asks for it (``use_wandb: true``);
without the package a run warns and goes on, its metrics in the run
directory's ``metrics.jsonl`` alone.  The logging helpers act only on a run
that :func:`maybe_initialize_wandb` started, and never import the package
themselves.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path
from typing import Any, Optional

from fdtpu_torch.utils.config import flatten_config


def _active_run():
    module = sys.modules.get("wandb")
    return None if module is None else module.run


def maybe_initialize_wandb(cfg: dict[str, Any]) -> Optional[str]:
    """Start a run when ``cfg["use_wandb"]`` and the package is installed;
    returns its id (the run directory's name), else None."""
    if not bool(cfg.get("use_wandb", False)):
        return None
    try:
        import wandb
    except ImportError:
        logging.warning("use_wandb=true but wandb is not installed; continuing without it.")
        return None
    run = wandb.init(
        project=cfg.get("wandb_project", "FourierDiffusion"),
        entity=os.environ.get("WANDB_ENTITY"),
        mode=os.environ.get("WANDB_MODE", "online"),
        config=flatten_config(cfg),
    )
    return run.id


def maybe_log_wandb(record: dict[str, Any]) -> None:
    """Send a metrics record to the active run, if any."""
    run = _active_run()
    if run is not None:
        run.log(record)


def maybe_log_model(ckpt_path: Path | str, name: str = "model") -> None:
    """Upload a checkpoint directory as a model artifact of the active run,
    if any.  A failed upload is logged and training goes on."""
    run = _active_run()
    if run is None:
        return
    try:
        artifact = sys.modules["wandb"].Artifact(f"{name}-{run.id}", type="model")
        path = Path(ckpt_path)
        if path.is_dir():
            artifact.add_dir(str(path))
        else:
            artifact.add_file(str(path))
        run.log_artifact(artifact)
    except Exception as exc:  # noqa: BLE001 - an upload must not end the run
        logging.getLogger(__name__).warning(
            "wandb model-artifact upload failed (continuing): %s", exc)
