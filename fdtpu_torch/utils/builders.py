"""Builders: composed config dicts → the port's objects (port of
``fdtpu/utils/builders.py:27-118``).

Explicit registries map group names to classes, as in the JAX package.
"""

from __future__ import annotations

import logging
from functools import partial
from pathlib import Path
from typing import Any, Optional

import torch

from fdtpu_torch.data.datamodules import DATAMODULE_REGISTRY, Datamodule
from fdtpu_torch.diffusion.sde import SDE
from fdtpu_torch.metrics import MarginalWasserstein, MetricCollection, SlicedWasserstein
from fdtpu_torch.models.score_models import ScoreModel, ScoreModelConfig, init_score_model
from fdtpu_torch.train.checkpoint import SCHEDULER_REGISTRY
from fdtpu_torch.utils.device import DeviceLike, resolve_device

METRIC_REGISTRY = {
    "SlicedWasserstein": SlicedWasserstein,
    "MarginalWasserstein": MarginalWasserstein,
}


def build_datamodule(cfg: dict[str, Any]) -> Datamodule:
    dm_cfg = dict(cfg["datamodule"])
    name = dm_cfg.pop("name")
    return DATAMODULE_REGISTRY[name](**dm_cfg)


def build_scheduler(cfg: dict[str, Any], max_len: Optional[int] = None,
                    device: DeviceLike = None) -> SDE:
    sm = cfg["score_model"]
    ns = dict(sm["noise_scheduler"])
    cls = SCHEDULER_REGISTRY[ns.pop("class")]
    ns.pop("name", None)
    scheduler = cls(fourier_noise_scaling=bool(sm.get("fourier_noise_scaling", False)), **ns)
    if max_len is not None:
        scheduler = scheduler.with_noise_scaling(max_len, device)
    return scheduler


def build_model(
    cfg: dict[str, Any],
    dataset_params: dict[str, Any],
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> ScoreModel:
    """Complete the score-model config with the dataset's parameters and
    initialize the network from ``generator`` (default: seeded with
    ``random_seed``) on ``device`` (CUDA unless ``"cpu"``)."""
    sm = dict(cfg["score_model"])
    sm.pop("noise_scheduler", None)
    sm.pop("name", None)
    lr_max = float(sm.pop("lr_max", 1e-3))
    likelihood_weighting = bool(sm.pop("likelihood_weighting", False))
    sm.pop("fourier_noise_scaling", None)
    model_cfg = ScoreModelConfig(
        n_channels=dataset_params["n_channels"],
        max_len=dataset_params["max_len"],
        **{k: v for k, v in sm.items() if k in ScoreModelConfig.__dataclass_fields__},
    )
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("random_seed", 42)))
    dev = resolve_device(device)
    model = ScoreModel(
        config=model_cfg,
        network=init_score_model(model_cfg, generator, dev),
        scheduler=build_scheduler(cfg, max_len=model_cfg.max_len, device=dev),
        num_training_steps=int(dataset_params["num_training_steps"]),
        lr_max=lr_max,
        likelihood_weighting=likelihood_weighting,
    )
    logging.info("Initialized %s model with %d parameters", model_cfg.backbone,
                 model.param_count())
    return model


def build_metrics(cfg: dict[str, Any], original_samples) -> MetricCollection:
    m_cfg = cfg["metrics"]
    factories = []
    for entry in m_cfg["metrics"]:
        entry = dict(entry)
        cls = METRIC_REGISTRY[entry.pop("type")]
        factories.append(partial(cls, **entry))
    return MetricCollection(
        metrics=factories,
        original_samples=original_samples,
        include_baselines=bool(m_cfg.get("include_baselines", True)),
        include_spectral_density=bool(m_cfg.get("include_spectral_density", False)),
    )


def resolve_model_dir(model_path: Path | str, model_id: str) -> Path:
    """A run directory; ``latest`` is the newest run holding a
    ``train_config.yaml``."""
    model_path = Path(model_path)
    model_id = str(model_id)
    runs = [p for p in model_path.glob("*") if (p / "train_config.yaml").exists()]
    if model_id != "latest":
        model_dir = model_path / model_id
        if not (model_dir / "train_config.yaml").exists():
            raise FileNotFoundError(
                f"No run {model_id} in {model_path}. Available: {sorted(p.name for p in runs)}")
        return model_dir
    if not runs:
        raise FileNotFoundError(f"No runs with train_config.yaml in {model_path}")
    return max(runs, key=lambda p: p.stat().st_mtime)
