"""Training CLI of the port (port of ``cli/train.py``).

Usage:
    python -m fdtpu_torch.cli.train [--config-name NAME] [overrides...]
    python -m fdtpu_torch.cli.train datamodule=synthetic fourier_transform=true \\
        trainer.max_epochs=10 score_model=lstm

Composes ``configs/train.yaml`` (or ``NAME.yaml``), builds the datamodule and
the score model, saves the composed config as ``train_config.yaml`` in the run
directory (``run_dir/run_id``), and fits: checkpoints in ``checkpoints/``,
the resume snapshot in ``resume/``, metrics in ``metrics.jsonl``.  It runs on
the CUDA card; ``+device=cpu`` runs it on the CPU.

Under ``torchrun --nproc-per-node N`` (one process a card) it starts the
process group torchrun describes (NCCL, each process on the card of its
``LOCAL_RANK``; gloo with ``+device=cpu``), and ``trainer.use_mesh`` (true in
``configs/trainer/default.yaml``) trains data-parallel over all N; only rank
0 writes the run's files.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from fdtpu_torch.dist.parallel import writes
from fdtpu_torch.sampling import DiffusionSampler
from fdtpu_torch.train import Trainer, get_training_params
from fdtpu_torch.train.callbacks import DiffusionMethodComparisonCallback, SamplingCallback
from fdtpu_torch.utils.builders import build_datamodule, build_model
from fdtpu_torch.utils.config import (
    CONFIG_DIR,
    compose_config,
    dict_to_str,
    flatten_config,
    save_config,
    split_config_name,
)
from fdtpu_torch.utils.device import resolve_device
from fdtpu_torch.utils.wandb import maybe_initialize_wandb

# The trainer group's keys that are Trainer arguments (cli/train.py:55-62).
TRAINER_KEYS = ("max_epochs", "gradient_clip_val", "log_every_n_steps", "use_mesh",
                "accumulate_grad_batches", "steps_per_call", "epochs_per_call")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start_world(device: torch.device) -> torch.device:
    """Under torchrun (``WORLD_SIZE`` > 1): start its process group, NCCL
    on this process's card or gloo on the CPU, and return the device; else
    ``device`` as it is."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


class TrainingRunner:
    """Build everything a training run needs from a composed config."""

    def __init__(self, cfg: dict[str, Any]) -> None:
        self.cfg = cfg
        logging.info("Training config:\n%s", dict_to_str(flatten_config(cfg)))
        started = dist.is_initialized()
        self.device = _start_world(resolve_device(cfg.get("device")))
        self.started_world = dist.is_initialized() and not started

        self.datamodule = build_datamodule(cfg)
        self.datamodule.prepare_data()
        self.datamodule.setup("fit")

        trainer_cfg = cfg["trainer"]
        self.trainer = Trainer(
            run_dir=cfg.get("run_dir", "lightning_logs"),
            run_id=cfg.get("run_id"),
            seed=int(cfg.get("random_seed", 42)),
            **{k: trainer_cfg[k] for k in TRAINER_KEYS if k in trainer_cfg},
        )
        # The run's config, which the sample CLI rebuilds the data from.
        if writes():
            save_config(cfg, self.trainer.run_dir / "train_config.yaml")

        params = get_training_params(self.datamodule, self.trainer.max_epochs,
                                     accumulate_grad_batches=self.trainer.accumulate_grad_batches)
        self.model = build_model(cfg, params,
                                 generator=torch.Generator().manual_seed(int(cfg["random_seed"])),
                                 device=self.device)
        if self.model.scheduler.fourier_noise_scaling and not cfg["fourier_transform"]:
            raise ValueError("fourier_noise_scaling=true requires fourier_transform=true")

        dc = trainer_cfg.get("diffusion_comparison") or {}
        if dc.get("enabled"):
            self.trainer.callbacks.append(DiffusionMethodComparisonCallback(
                model_template=self.model,
                methods=dc.get("methods", []),
                every_n_epochs=int(dc.get("every_n_epochs", 1)),
                num_samples=int(dc.get("num_samples", 5)),
                warmup_steps=int(dc.get("warmup_steps", 2)),
                sample_batch_size=int(dc.get("num_samples", 5)),
                random_seed=int(cfg.get("random_seed", 42)),
            ))
        sc = trainer_cfg.get("sampling_callback") or {}
        if sc.get("enabled"):
            self.trainer.callbacks.append(SamplingCallback(
                datamodule=self.datamodule,
                model_template=self.model,
                every_n_epochs=int(sc.get("every_n_epochs", 10)),
                sample_batch_size=int(sc.get("sample_batch_size", 64)),
                num_samples=int(sc.get("num_samples", 200)),
                num_diffusion_steps=int(sc.get("num_diffusion_steps", 1000)),
                num_directions=int(sc.get("num_directions", 200)),
                random_seed=int(cfg.get("random_seed", 42)),
            ))

    def train(self) -> None:
        self.trainer.fit(self.model, self.datamodule)
        logging.info("Run %s finished; best val/loss %.5f; checkpoints in %s",
                     self.trainer.run_id, self.trainer.best_val_loss,
                     self.trainer.run_dir / "checkpoints")
        self._maybe_cache_benchmark()

    def _maybe_cache_benchmark(self) -> None:
        """Cached against uncached sampling time on the trained model
        (``configs/train_with_cache_benchmark.yaml``), written to
        ``cache_benchmark.json``."""
        cb = self.cfg.get("cache_benchmark") or {}
        if not cb or not writes():
            return
        num_samples = int(cb.get("num_samples", 5))
        steps = int(cb.get("num_diffusion_steps", 5))
        batch = int(cb.get("sample_batch_size", num_samples))
        results: dict[str, Any] = {}
        for name, kwargs in (
            ("uncached", {}),
            ("cached", dict(use_cache=True, cache_kwargs=dict(cb.get("cache_kwargs") or {}),
                            use_fresca=bool(cb.get("use_fresca", False)),
                            **(cb.get("fresca_kwargs") or {}))),
        ):
            sampler = DiffusionSampler(self.model, sample_batch_size=batch, **kwargs)
            sampler.sample(num_samples, steps,
                           generator=torch.Generator(device=self.device).manual_seed(0))
            sampler.last_cache_state = None
            _sync(self.device)
            t0 = time.perf_counter()
            sampler.sample(num_samples, steps,
                           generator=torch.Generator(device=self.device).manual_seed(1))
            _sync(self.device)
            results[name] = {"time_s": time.perf_counter() - t0}
            if kwargs.get("use_cache"):
                results[name]["cache_stats"] = sampler.get_cache_stats()
        results["speedup"] = results["uncached"]["time_s"] / results["cached"]["time_s"]
        out = self.trainer.run_dir / "cache_benchmark.json"
        out.write_text(json.dumps(results, indent=2))
        logging.info("cache benchmark: %.2fx speedup (results in %s)", results["speedup"], out)


def main(argv: Optional[list[str]] = None) -> TrainingRunner:
    """Compose the config from ``argv`` (default ``sys.argv[1:]``), train,
    and return the runner."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", force=True)
    config_name, overrides = split_config_name(
        sys.argv[1:] if argv is None else list(argv), "train")
    cfg = compose_config(CONFIG_DIR, config_name, overrides)
    run_id = maybe_initialize_wandb(cfg)
    if run_id:
        cfg["run_id"] = run_id
    runner = TrainingRunner(cfg)
    try:
        runner.train()
    finally:
        if runner.started_world:
            dist.destroy_process_group()
    return runner


if __name__ == "__main__":
    main()
