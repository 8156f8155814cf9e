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
``steps_per_call`` (default 16, as the JAX trainer's) takes that many
same-shape steps per call of :class:`GraphedSteps`: replays of a captured
step graph on the card, the same steps run directly on the CPU; the odd-sized
last batch of an epoch has a graph of its own.  Not ported here
(ROADMAP.md): the mesh, gradient accumulation, resume, checkpoint files,
callbacks, wandb and the device-resident epoch loop (``epochs_per_call``).
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
from fdtpu_torch.utils.graphs import GraphRunner


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
    loss = _loss_and_update(network, optimizer, scheduler, batch, generator,
                            likelihood_weighting)
    optimizer.count += 1
    return loss


def _loss_and_update(network, optimizer, scheduler, batch, generator, likelihood_weighting):
    """A step's device work: loss, backward, update (no host value)."""
    loss = sde_loss(network, scheduler, batch, generator=generator,
                    likelihood_weighting=likelihood_weighting, train=True)
    optimizer.zero_grad()
    loss.backward()
    optimizer.update()
    return loss.detach()


def group_same_shape(batches: list, cap: int):
    """``(start, run)`` spans of consecutive same-shape batches, ``run <=
    cap`` (``fdtpu/train/trainer.py:64``)."""
    i = 0
    while i < len(batches):
        run = 1
        while run < cap and i + run < len(batches) and batches[i + run].shape == batches[i].shape:
            run += 1
        yield i, run
        i += run


class GraphedSteps:
    """Consecutive optimizer steps as replays of one captured step graph per
    batch shape (``steps_per_call``; the JAX package's ``train_steps_scan``).

    A group of up to ``capacity`` same-shape batches is copied to the device
    at once into a static buffer; each replay takes batch ``j`` of it (a
    device counter the graph advances) and writes its loss into a static
    buffer that the host reads only when it logs.  One step graph replayed k
    times rather than a k-step graph: it serves every group length, the
    shorter last group of an epoch too, and a replay costs one graph launch
    next to a step of tens of milliseconds.  The trainer's generator (t, z,
    dropout) is registered with every graph, and the rate comes from the
    optimizer's device table, so the replayed steps are the eager steps.  On
    the CPU the same steps run directly."""

    def __init__(self, network, optimizer: ClippedAdamW, scheduler: SDE,
                 generator: torch.Generator, likelihood_weighting: bool, capacity: int) -> None:
        self.network = network
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.generator = generator
        self.likelihood_weighting = likelihood_weighting
        self.capacity = capacity
        self.device = optimizer.params[0].device
        self.runner = GraphRunner.for_device(self.device, (generator,))
        self.buffers: dict[tuple, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}

    def run(self, batches: list[np.ndarray]) -> torch.Tensor:
        """Take one optimizer step on each of ``batches`` (one shape);
        returns their losses, (len(batches),), not synced."""
        shape = batches[0].shape
        if shape not in self.buffers:
            self.buffers[shape] = (
                torch.empty((self.capacity, *shape), device=self.device),
                torch.zeros((self.capacity,), device=self.device),
                torch.zeros((1,), dtype=torch.int64, device=self.device),
            )
        chunk, losses, j = self.buffers[shape]
        n = len(batches)
        chunk[:n].copy_(torch.from_numpy(np.stack(batches)))
        j.zero_()
        for _ in range(n):
            self.runner.run(shape, lambda: self._step(chunk, losses, j))
            self.optimizer.count += 1
        return losses[:n].clone()

    def _step(self, chunk: torch.Tensor, losses: torch.Tensor, j: torch.Tensor) -> None:
        loss = _loss_and_update(self.network, self.optimizer, self.scheduler,
                                chunk.index_select(0, j)[0], self.generator,
                                self.likelihood_weighting)
        losses.index_copy_(0, j, loss.reshape(1))
        j.add_(1)


class Trainer:
    def __init__(
        self,
        max_epochs: int = 1,
        gradient_clip_val: float = 1.0,
        run_dir: Path | str = "lightning_logs",
        run_id: Optional[str] = None,
        seed: int = 42,
        log_every_n_steps: int = 50,
        steps_per_call: int = 16,
        epochs_per_call: int = 1,
    ) -> None:
        """``steps_per_call``: consecutive same-shape optimizer steps taken
        per call of :class:`GraphedSteps` (replays of a captured step graph on
        the card); 1 is the eager per-step loop.  The training trajectory is
        the same for every value.  ``epochs_per_call > 1`` is not ported yet
        (ROADMAP.md)."""
        if epochs_per_call > 1:
            raise NotImplementedError(
                "epochs_per_call > 1 (the device-resident epoch loop) is not ported yet "
                "(ROADMAP.md: epochs_per_call)"
            )
        self.max_epochs = max_epochs
        self.gradient_clip_val = gradient_clip_val
        self.seed = seed
        self.log_every_n_steps = log_every_n_steps
        self.steps_per_call = max(1, int(steps_per_call))
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
        spc = self.steps_per_call
        graphed = (GraphedSteps(network, optimizer, scheduler, generator,
                                model.likelihood_weighting, spc) if spc > 1 else None)
        train_loader = datamodule.train_dataloader()
        val_batches = [torch.from_numpy(b).to(device) for b in datamodule.val_dataloader()]
        best_state: Optional[dict[str, torch.Tensor]] = None
        global_step = 0

        for epoch in range(self.max_epochs):
            t0 = time.perf_counter()
            losses = []
            batches = list(train_loader)
            for i, run in group_same_shape(batches, spc):
                if graphed is None:
                    step_losses = train_step(network, optimizer, scheduler,
                                             torch.from_numpy(batches[i]).to(device), generator,
                                             model.likelihood_weighting).reshape(1)
                else:
                    step_losses = graphed.run(batches[i:i + run])
                losses.append(step_losses)
                for off in range(run):
                    global_step += 1
                    if global_step % self.log_every_n_steps == 0:
                        self._log({"step": global_step, "epoch": epoch,
                                   "train/loss": float(step_losses[off]),
                                   "lr": optimizer.schedule(global_step)})
            train_loss = float(torch.cat(losses).mean())

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
