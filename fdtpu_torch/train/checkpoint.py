"""Checkpoints and the resume snapshot (port of ``fdtpu/train/checkpoint.py``).

The directory layout and ``meta.json`` keys are the JAX package's: a
checkpoint is ``run_dir/checkpoints/epoch=N-val_loss=X.ckpt/`` holding the
network's parameters and ``meta.json`` (epoch, val loss, model config,
scheduler, training hyperparameters), from which the model is rebuilt; the
resume snapshot is ``run_dir/resume/`` with the training state and a
``meta.json`` of (epoch, global_step, best_val_loss), overwritten each epoch.
The tensors go through ``torch.save`` in place of orbax and are read back
with ``weights_only=True``: tensors, numbers and containers only, no code.
A JAX checkpoint's weights reach the port through numpy and
:func:`fdtpu_torch.utils.convert.load_jax_variables`.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Optional

import torch

from fdtpu_torch.diffusion.sde import SDE, VEScheduler, VPScheduler
from fdtpu_torch.models.score_models import ScoreModel, ScoreModelConfig, init_score_model
from fdtpu_torch.utils.device import DeviceLike

SCHEDULER_REGISTRY = {"VPScheduler": VPScheduler, "VEScheduler": VEScheduler}
NETWORK_FILE = "variables.pt"
STATE_FILE = "state.pt"


def scheduler_to_meta(scheduler: SDE) -> dict[str, Any]:
    meta = {
        "class": type(scheduler).__name__,
        "fourier_noise_scaling": scheduler.fourier_noise_scaling,
        "eps": scheduler.eps,
    }
    if isinstance(scheduler, VPScheduler):
        meta.update(beta_min=scheduler.beta_min, beta_max=scheduler.beta_max)
    elif isinstance(scheduler, VEScheduler):
        meta.update(sigma_min=scheduler.sigma_min, sigma_max=scheduler.sigma_max)
    return meta


def scheduler_from_meta(meta: dict[str, Any], max_len: int, device: DeviceLike = None) -> SDE:
    cls = SCHEDULER_REGISTRY[meta["class"]]
    kwargs = {k: float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else v
              for k, v in meta.items() if k != "class"}
    return cls(**kwargs).with_noise_scaling(max_len, device)


def save_checkpoint(run_dir: Path, model: ScoreModel, epoch: int, val_loss: float) -> Path:
    ckpt_dir = Path(run_dir) / "checkpoints" / f"epoch={epoch}-val_loss={val_loss:.2f}.ckpt"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.network.state_dict().items()}
    torch.save(state, ckpt_dir / NETWORK_FILE)
    meta = {
        "epoch": epoch,
        "val_loss": val_loss,
        "model_config": dataclasses.asdict(model.config),
        "scheduler": scheduler_to_meta(model.scheduler),
        "num_training_steps": model.num_training_steps,
        "lr_max": model.lr_max,
        "likelihood_weighting": model.likelihood_weighting,
    }
    with open(ckpt_dir / "meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return ckpt_dir


def load_network_state(ckpt_dir: Path | str) -> dict[str, torch.Tensor]:
    """A checkpoint's network state dict, on the CPU."""
    return torch.load(Path(ckpt_dir) / NETWORK_FILE, map_location="cpu", weights_only=True)


def load_checkpoint(ckpt_dir: Path | str, device: DeviceLike = None,
                    **config_overrides: Any) -> ScoreModel:
    """Restore a checkpoint on ``device`` (CUDA unless ``"cpu"``), frozen for
    sampling.  ``config_overrides`` replace :class:`ScoreModelConfig` fields
    that are runtime choices rather than part of the weights
    (``attention_impl="auto"``, ``compute_dtype``)."""
    ckpt_dir = Path(ckpt_dir)
    with open(ckpt_dir / "meta.json") as f:
        meta = json.load(f)
    config = ScoreModelConfig(**{**meta["model_config"], **config_overrides})
    network = init_score_model(config, device=device)
    network.load_state_dict(load_network_state(ckpt_dir), strict=True)
    return ScoreModel(
        config=config,
        network=network,
        scheduler=scheduler_from_meta(meta["scheduler"], config.max_len,
                                      next(network.parameters()).device),
        num_training_steps=meta.get("num_training_steps", 1000),
        lr_max=meta.get("lr_max", 1e-3),
        likelihood_weighting=meta.get("likelihood_weighting", False),
    )


def save_train_state(
    run_dir: Path,
    state: dict[str, Any],
    epoch: int,
    global_step: int,
    best_val_loss: float,
) -> Path:
    """The mid-training resume snapshot: ``state`` (the network's parameters,
    the optimizer's state and the training generator's state; tensors,
    numbers and containers) and the loop's position, overwritten each epoch.
    Restoring it reproduces the uninterrupted run: the same data order, the
    same draws, the same optimizer trajectory."""
    resume_dir = Path(run_dir) / "resume"
    resume_dir.mkdir(parents=True, exist_ok=True)
    torch.save(state, resume_dir / STATE_FILE)
    with open(resume_dir / "meta.json", "w") as f:
        json.dump({"epoch": epoch, "global_step": global_step,
                   "best_val_loss": best_val_loss}, f)
    return resume_dir


def load_train_state(run_dir: Path) -> Optional[tuple[dict[str, Any], dict[str, Any]]]:
    """``(state, meta)`` of a :func:`save_train_state` snapshot (tensors on
    the CPU), or None if there is none."""
    resume_dir = Path(run_dir) / "resume"
    if not (resume_dir / "meta.json").exists():
        return None
    with open(resume_dir / "meta.json") as f:
        meta = json.load(f)
    state = torch.load(resume_dir / STATE_FILE, map_location="cpu", weights_only=True)
    return state, meta


def get_best_checkpoint(checkpoint_path: Path | str) -> Path:
    """The lowest-val-loss checkpoint by its name; equal rounded losses go
    to the later epoch (a checkpoint is saved only on a strict improvement,
    so the later one is the better)."""
    pattern = r"epoch=(\d+)-val_loss=(-?\d+\.\d+)\.ckpt"
    best_key: Optional[tuple[float, int]] = None
    best: Optional[Path] = None
    for ckpt in Path(checkpoint_path).glob("*.ckpt"):
        match = re.search(pattern, ckpt.name)
        if match is None:
            continue
        key = (float(match.group(2)), -int(match.group(1)))
        if best_key is None or key < best_key:
            best_key = key
            best = ckpt
    if best is None:
        raise FileNotFoundError(f"No checkpoints found in {checkpoint_path}")
    return best
