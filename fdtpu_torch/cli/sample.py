"""Sampling CLI of the port (port of ``cli/sample.py``).

Usage:
    python -m fdtpu_torch.cli.sample model_id=<run_id|latest> \\
        [num_samples=... num_diffusion_steps=... use_cache=true ...]

Loads the run's ``train_config.yaml``, rebuilds the datamodule, restores the
best checkpoint, samples (uncached, E²-CRF-cached at any level, with FreSca,
or cached at a calibrated τ₀ under ``+calibrate_tau=true``), maps the samples
back to the data domain, scores them with the Wasserstein metrics against
the training data, and writes ``results.yaml``, ``samples.npy`` and
``sample_config.yaml`` into the run directory (with ``samples_cache/`` and
``cache_stats.yaml`` when cached, ``calibration.yaml`` when calibrated).  It
runs on the CUDA card; ``+device=cpu`` runs it on the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from typing import Any, Optional

import numpy as np
import torch

from fdtpu_torch.data.dataset import DiffusionDataset
from fdtpu_torch.sampling import DiffusionSampler, calibrate_tau_0
from fdtpu_torch.train import get_best_checkpoint, load_checkpoint
from fdtpu_torch.train.callbacks import to_data_domain
from fdtpu_torch.utils import yaml_subset
from fdtpu_torch.utils.builders import build_datamodule, build_metrics, resolve_model_dir
from fdtpu_torch.utils.config import CONFIG_DIR, compose_config, load_config, save_config
from fdtpu_torch.utils.device import resolve_device


class SamplingRunner:
    """Restore a trained run and set up its sampler from a composed config."""

    def __init__(self, cfg: dict[str, Any]) -> None:
        self.cfg = cfg
        self.device = resolve_device(cfg.get("device"))
        self.model_dir = resolve_model_dir(cfg["model_path"], cfg["model_id"])
        logging.info("Sampling from run %s", self.model_dir)

        self.train_cfg = load_config(self.model_dir / "train_config.yaml")
        self.datamodule = build_datamodule(self.train_cfg)
        self.datamodule.prepare_data()
        self.datamodule.setup("fit")

        ckpt = get_best_checkpoint(self.model_dir / "checkpoints")
        logging.info("Loading checkpoint %s", ckpt)
        # attention_impl is a hardware choice, not part of the weights.
        overrides = {"attention_impl": cfg["attention_impl"]} if cfg.get("attention_impl") else {}
        self.model = load_checkpoint(ckpt, device=self.device, **overrides)

        sampler_cfg = dict(cfg["sampler"])
        sampler_cfg.pop("name", None)
        # The cache flags may sit at the root (sample.yaml) or under the
        # sampler group (+sampler.use_cache=true); the sampler's win.
        use_cache = bool(sampler_cfg.pop("use_cache", cfg.get("use_cache", False)))
        cache_kwargs = sampler_cfg.pop("cache_kwargs", None) or cfg.get("cache_kwargs") or {}
        use_fresca = bool(sampler_cfg.pop("use_fresca", cfg.get("use_fresca", False)))
        # +calibrate_tau=true: pick τ₀ by pilot sampling, or sample uncached
        # when no ladder arm is safe (fdtpu_torch/sampling/calibrate.py).
        self.calibration = None
        if use_cache and bool(sampler_cfg.pop("calibrate_tau", cfg.get("calibrate_tau", False))):
            cal_kwargs = dict(cfg.get("calibrate_kwargs") or {})
            pilot_n = int(cal_kwargs.pop("num_samples", min(int(cfg["num_samples"]), 128)))
            batch = min(int(sampler_cfg.get("sample_batch_size", pilot_n)), pilot_n)
            self.calibration = calibrate_tau_0(
                self.model,
                num_samples=pilot_n,
                num_diffusion_steps=int(cfg["num_diffusion_steps"]),
                sample_batch_size=batch,
                seed=int(cfg["random_seed"]) + 1,
                cache_kwargs=cache_kwargs,
                **cal_kwargs,
            )
            if self.calibration.tau_0 is None:
                logging.warning(
                    "tau_0 calibration: no ladder arm stayed within the noise floor with a "
                    "silent guard — sampling UNCACHED. Arms: %s", self.calibration.arms)
                use_cache = False
            else:
                cache_kwargs = self.calibration.cache_kwargs
                logging.info("tau_0 calibration: chose tau_0=%s (floor %.4g): %s",
                             self.calibration.tau_0, self.calibration.sw_noise_floor,
                             self.calibration.accepted)
        self.sampler = DiffusionSampler(
            self.model,
            use_cache=use_cache,
            cache_kwargs=cache_kwargs,
            use_fresca=use_fresca,
            **(cfg.get("fresca_kwargs") or {}),
            **sampler_cfg,
        )
        self.metrics = build_metrics(cfg, original_samples=self.datamodule.X_train)
        self.train_set = DiffusionDataset(
            X=self.datamodule.X_train,
            fourier_transform=self.datamodule.fourier_transform,
            standardize=self.datamodule.standardize,
        )

    def sample(self) -> dict[str, Any]:
        """Sample, score and write the run's artifacts; returns the metrics."""
        cfg = self.cfg
        x = self.sampler.sample(
            int(cfg["num_samples"]), int(cfg["num_diffusion_steps"]),
            generator=torch.Generator(device=self.device).manual_seed(int(cfg["random_seed"])),
        )
        x = to_data_domain(x, self.datamodule, self.train_set)

        results = self.metrics(x)
        scalars = {k: v for k, v in results.items() if not isinstance(v, list)}
        logging.info("Metrics:\n%s", yaml_subset.dumps(scalars))

        save_config(cfg, self.model_dir / "sample_config.yaml")
        yaml_subset.dump(results, self.model_dir / "results.yaml")
        np.save(self.model_dir / "samples.npy", x)
        if self.sampler.use_cache:
            cache_dir = self.model_dir / "samples_cache"
            cache_dir.mkdir(exist_ok=True)
            np.save(cache_dir / "samples.npy", x)
            stats = self.sampler.get_cache_stats()
            yaml_subset.dump(stats, self.model_dir / "cache_stats.yaml")
            logging.info("Cache stats: %s", stats)
        if self.calibration is not None:
            yaml_subset.dump({
                "tau_0": self.calibration.tau_0,
                "sw_noise_floor": float(self.calibration.sw_noise_floor),
                "arms": [dataclasses.asdict(a) for a in self.calibration.arms],
            }, self.model_dir / "calibration.yaml")
        logging.info("Saved results.yaml and samples.npy to %s", self.model_dir)
        return results


def main(argv: Optional[list[str]] = None) -> SamplingRunner:
    """Compose ``configs/sample.yaml`` with ``argv`` (default
    ``sys.argv[1:]``), sample, and return the runner."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", force=True)
    cfg = compose_config(CONFIG_DIR, "sample", sys.argv[1:] if argv is None else list(argv))
    runner = SamplingRunner(cfg)
    runner.sample()
    return runner


if __name__ == "__main__":
    main()
