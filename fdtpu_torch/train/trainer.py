"""Training loop of the port (the host loop of ``fdtpu/train/trainer.py:55-463``).

One step is DSM loss → backward → global-norm clip → AdamW → schedule step
(:func:`train_step`).  Every epoch ends with the val loss in eval mode,
averaged with batch-size weights, and best-val tracking: the model handed
back holds the parameters of the best val epoch (the last epoch's when no
val loss was finite), frozen for sampling.  Each epoch and every
``log_every_n_steps`` steps append a record to ``run_dir/run_id/metrics.jsonl``
with the JAX trainer's keys.

Every random draw (t, z and the dropout masks) comes from one
``torch.Generator`` seeded with ``Trainer.seed`` on the network's device; the
loop runs where the caller's network lives (the card unless it is on the CPU).
Not ported here (ROADMAP.md): the mesh, gradient accumulation, resume,
checkpoint files, callbacks, wandb and the multi-step/device-resident loops.
"""

from __future__ import annotations

import copy
import json
import logging
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from fdtpu_torch.diffusion.losses import sde_loss
from fdtpu_torch.diffusion.sde import SDE
from fdtpu_torch.models.score_models import ScoreModel, ScoreNetwork
from fdtpu_torch.train.state import ClippedAdamW, make_optimizer
from fdtpu_torch.utils.device import module_device


def get_training_params(datamodule: Any, max_epochs: int) -> dict[str, Any]:
    """Dataset-derived model kwargs: ``n_channels``, ``max_len`` and
    ``num_training_steps`` = batches per epoch × ``max_epochs``."""
    params = dict(datamodule.dataset_parameters)
    params["num_training_steps"] = int(params["num_training_steps"] * max_epochs)
    return params


def train_step(
    network: ScoreNetwork,
    optimizer: ClippedAdamW,
    scheduler: SDE,
    batch: torch.Tensor,
    generator: torch.Generator,
    likelihood_weighting: bool = False,
) -> torch.Tensor:
    """One optimizer step on ``batch``; returns the loss (not synced)."""
    loss = sde_loss(network, scheduler, batch, generator=generator,
                    likelihood_weighting=likelihood_weighting, train=True)
    optimizer.zero_grad()
    loss.backward()
    optimizer.step()
    return loss.detach()


class Trainer:
    def __init__(
        self,
        max_epochs: int = 1,
        gradient_clip_val: float = 1.0,
        run_dir: Path | str = "lightning_logs",
        run_id: Optional[str] = None,
        seed: int = 42,
        log_every_n_steps: int = 50,
    ) -> None:
        self.max_epochs = max_epochs
        self.gradient_clip_val = gradient_clip_val
        self.seed = seed
        self.log_every_n_steps = log_every_n_steps
        self.run_id = run_id if run_id is not None else time.strftime("%Y%m%d_%H%M%S")
        self.run_dir = Path(run_dir) / self.run_id
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.metrics_path = self.run_dir / "metrics.jsonl"
        self.best_val_loss = float("inf")

    def fit(self, model: ScoreModel, datamodule: Any) -> ScoreModel:
        """Train a copy of ``model.network``; set ``model.network`` to the
        best-val parameters, frozen, and return ``model``."""
        device = module_device(model.network)
        network = copy.deepcopy(model.network).train().requires_grad_(True)
        generator = torch.Generator(device=device).manual_seed(self.seed)
        optimizer = make_optimizer(
            network.parameters(), model.lr_max, model.num_training_steps,
            gradient_clip_val=self.gradient_clip_val,
        )
        scheduler = model.scheduler
        train_loader = datamodule.train_dataloader()
        val_batches = [torch.from_numpy(b).to(device) for b in datamodule.val_dataloader()]
        best_state: Optional[dict[str, torch.Tensor]] = None
        global_step = 0

        for epoch in range(self.max_epochs):
            t0 = time.perf_counter()
            losses = []
            for batch in train_loader:
                loss = train_step(network, optimizer, scheduler,
                                  torch.from_numpy(batch).to(device), generator,
                                  model.likelihood_weighting)
                losses.append(loss)
                global_step += 1
                if global_step % self.log_every_n_steps == 0:
                    self._log({"step": global_step, "epoch": epoch,
                               "train/loss": float(loss), "lr": optimizer.lr})
            train_loss = float(torch.stack(losses).mean())

            with torch.no_grad():
                val_losses = [
                    sde_loss(network, scheduler, xb, generator=generator,
                             likelihood_weighting=model.likelihood_weighting, train=False)
                    for xb in val_batches
                ]
            val_loss = (
                float(np.average(torch.stack(val_losses).cpu().numpy(),
                                 weights=[len(xb) for xb in val_batches]))
                if val_losses else float("nan")
            )
            dt = time.perf_counter() - t0
            self._log({"step": global_step, "epoch": epoch, "train/loss_epoch": train_loss,
                       "val/loss": val_loss, "epoch_time_s": round(dt, 2),
                       "lr": optimizer.lr})
            logging.info("epoch %d: train/loss %.5f val/loss %.5f (%.1fs)",
                         epoch, train_loss, val_loss, dt)
            if val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                best_state = {k: v.detach().clone() for k, v in network.state_dict().items()}

        if best_state is not None:
            network.load_state_dict(best_state)
        model.network = network.eval().requires_grad_(False)
        return model

    def _log(self, record: dict[str, Any]) -> None:
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
