"""Training loop of the port (the host loop of ``fdtpu/train/trainer.py:55-463``).

One step is DSM loss → backward → global-norm clip → AdamW → schedule step
(:func:`train_step`); with ``accumulate_grad_batches`` k the update comes
every k-th micro-step from the mean of k gradients (``optax.MultiSteps``,
:mod:`fdtpu_torch.train.state`).  Every epoch ends with the val loss in eval
mode, averaged with batch-size weights, and best-val tracking: each
improvement writes a checkpoint (:mod:`fdtpu_torch.train.checkpoint`), and
the model handed back holds the parameters of the best val epoch (the last
epoch's when no val loss was finite), frozen for sampling.  Each epoch and
every ``log_every_n_steps`` steps append a record to
``run_dir/run_id/metrics.jsonl`` with the JAX trainer's keys (and to wandb
when a run is active, :mod:`fdtpu_torch.utils.wandb`).  Then the resume
snapshot is written (``save_resume_state``) and each callback's
``on_train_epoch_end(trainer=, network=, epoch=)`` runs.  ``resume=True``
restores the snapshot of ``run_dir/run_id`` and continues the run as it
would have gone on uninterrupted.

Every random draw (t, z and the dropout masks) comes from one
``torch.Generator`` seeded with ``Trainer.seed`` on the network's device; the
loop runs where the caller's network lives (the card unless it is on the CPU).
``steps_per_call`` (default 16, as the JAX trainer's) takes that many
same-shape steps per call of :class:`GraphedSteps`: replays of a captured
step graph on the card, the same steps run directly on the CPU; the odd-sized
last batch of an epoch has a graph of its own.  Not ported here
(ROADMAP.md): the dp×tp mesh (one device only) and the device-resident epoch
loop (``epochs_per_call``).
"""

from __future__ import annotations

import copy
import dataclasses
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
from fdtpu_torch.train import checkpoint
from fdtpu_torch.train.state import ClippedAdamW, make_optimizer
from fdtpu_torch.utils import wandb
from fdtpu_torch.utils.device import module_device
from fdtpu_torch.utils.graphs import GraphRunner


def get_training_params(
    datamodule: Any, max_epochs: int, accumulate_grad_batches: int = 1
) -> dict[str, Any]:
    """Dataset-derived model kwargs: ``n_channels``, ``max_len`` and
    ``num_training_steps`` = batches per epoch × ``max_epochs`` /
    ``accumulate_grad_batches`` (the optimizer updates)."""
    params = dict(datamodule.dataset_parameters)
    params["num_training_steps"] = int(
        params["num_training_steps"] * max_epochs / accumulate_grad_batches
    )
    return params


def train_step(
    network: ScoreNetwork,
    optimizer: ClippedAdamW,
    scheduler: SDE,
    batch: torch.Tensor,
    generator: torch.Generator,
    likelihood_weighting: bool = False,
) -> torch.Tensor:
    """One optimizer micro-step on ``batch``; returns the loss (not
    synced)."""
    loss = _loss_and_update(network, optimizer, scheduler, batch, generator,
                            likelihood_weighting)
    optimizer.advance()
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
    batch shape (``steps_per_call``; the JAX package's ``train_steps_scan``),
    two under gradient accumulation: the micro-step that only accumulates
    and the one that also updates (:attr:`ClippedAdamW.emits`).

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
            self.runner.run((shape, self.optimizer.emits),
                            lambda: self._step(chunk, losses, j))
            self.optimizer.advance()
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
        use_mesh: bool = True,
        mesh: Optional[Any] = None,
        log_every_n_steps: int = 50,
        callbacks: Optional[list] = None,
        accumulate_grad_batches: int = 1,
        resume: bool = False,
        save_resume_state: bool = True,
        steps_per_call: int = 16,
        epochs_per_call: int = 1,
    ) -> None:
        """``accumulate_grad_batches``: micro-batches per optimizer update
        (the schedule advances once per update).  ``resume``: restore the
        snapshot in ``run_dir/run_id/resume`` and continue that run exactly;
        ``save_resume_state``: write it at every epoch end.
        ``steps_per_call``: consecutive same-shape optimizer steps taken per
        call of :class:`GraphedSteps` (replays of a captured step graph on
        the card); 1 is the eager per-step loop.  The training trajectory is
        the same for every value.  ``use_mesh`` on one device changes
        nothing, as with one JAX device; a mesh over several devices and
        ``epochs_per_call > 1`` are not ported yet (ROADMAP.md)."""
        if epochs_per_call > 1:
            raise NotImplementedError(
                "epochs_per_call > 1 (the device-resident epoch loop) is not ported yet "
                "(ROADMAP.md: epochs_per_call)"
            )
        if mesh is not None:
            raise NotImplementedError("mesh is not ported yet (ROADMAP.md: distribution)")
        self.max_epochs = max_epochs
        self.gradient_clip_val = gradient_clip_val
        self.seed = seed
        self.use_mesh = use_mesh
        self.log_every_n_steps = log_every_n_steps
        self.callbacks = list(callbacks or [])
        self.accumulate_grad_batches = max(1, int(accumulate_grad_batches))
        self.resume = resume
        self.save_resume_state = save_resume_state
        self.steps_per_call = max(1, int(steps_per_call))
        self.run_id = run_id if run_id is not None else time.strftime("%Y%m%d_%H%M%S")
        self.run_dir = Path(run_dir) / self.run_id
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.metrics_path = self.run_dir / "metrics.jsonl"
        self.best_val_loss = float("inf")
        self.best_checkpoint: Optional[Path] = None

    def _check_mesh(self, device: torch.device) -> None:
        if not self.use_mesh:
            return
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            raise NotImplementedError(
                f"use_mesh over {torch.cuda.device_count()} CUDA devices: the dp×tp mesh "
                "is not ported yet (ROADMAP.md: distribution); pass use_mesh=False or "
                "make one device visible")
        logging.info("use_mesh on one device: no mesh (the dp×tp mesh is ROADMAP A.8)")

    def fit(self, model: ScoreModel, datamodule: Any) -> ScoreModel:
        """Train a copy of ``model.network``; set ``model.network`` to the
        best-val parameters, frozen, and return ``model``."""
        device = module_device(model.network)
        self._check_mesh(device)
        network = copy.deepcopy(model.network).train().requires_grad_(True)
        generator = torch.Generator(device=device).manual_seed(self.seed)
        optimizer = make_optimizer(
            network.parameters(), model.lr_max, model.num_training_steps,
            gradient_clip_val=self.gradient_clip_val,
            accumulate_grad_batches=self.accumulate_grad_batches,
        )
        best_state: Optional[dict[str, torch.Tensor]] = None
        start_epoch = global_step = 0
        if self.resume:
            restored = checkpoint.load_train_state(self.run_dir)
            if restored is not None:
                state, meta = restored
                network.load_state_dict(state["network"])
                optimizer.load_state_dict(state["optimizer"])
                generator.set_state(state["generator"])
                start_epoch = int(meta["epoch"]) + 1
                global_step = int(meta["global_step"])
                self.best_val_loss = float(meta["best_val_loss"])
                ckpts = self.run_dir / "checkpoints"
                if any(ckpts.glob("*.ckpt")):
                    self.best_checkpoint = checkpoint.get_best_checkpoint(ckpts)
                    best_state = checkpoint.load_network_state(self.best_checkpoint)
                logging.info("resuming from epoch %d (global step %d)", start_epoch, global_step)
        scheduler = model.scheduler
        spc = self.steps_per_call
        graphed = (GraphedSteps(network, optimizer, scheduler, generator,
                                model.likelihood_weighting, spc) if spc > 1 else None)
        train_loader = datamodule.train_dataloader()
        if start_epoch:
            train_loader.skip_epochs(start_epoch)
        val_batches = [torch.from_numpy(b).to(device) for b in datamodule.val_dataloader()]
        per_update = self.accumulate_grad_batches

        for epoch in range(start_epoch, self.max_epochs):
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
                                   "lr": optimizer.schedule(global_step // per_update)})
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
                       "lr": optimizer.schedule(global_step // per_update)})
            logging.info("epoch %d: train/loss %.5f val/loss %.5f (%.1fs)",
                         epoch, train_loss, val_loss, dt)
            if val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                best_state = {k: v.detach().clone() for k, v in network.state_dict().items()}
                self.best_checkpoint = checkpoint.save_checkpoint(
                    self.run_dir, dataclasses.replace(model, network=network), epoch, val_loss)
                wandb.maybe_log_model(self.best_checkpoint)
            if self.save_resume_state:
                checkpoint.save_train_state(
                    self.run_dir,
                    {"network": network.state_dict(), "optimizer": optimizer.state_dict(),
                     "generator": generator.get_state()},
                    epoch=epoch, global_step=global_step, best_val_loss=self.best_val_loss)
            for callback in self.callbacks:
                callback.on_train_epoch_end(trainer=self, network=network, epoch=epoch)

        if best_state is not None:
            network.load_state_dict(best_state)
        model.network = network.eval().requires_grad_(False)
        return model

    def _log(self, record: dict[str, Any]) -> None:
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        wandb.maybe_log_wandb(record)
