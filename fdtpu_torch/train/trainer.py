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
last batch of an epoch has a graph of its own.

``epochs_per_call`` > 1 is the JAX package's device-resident loop
(``_fit_on_device``, :class:`ResidentEpochs`): the standardised splits on the
device, the shuffle a device permutation drawn from the trainer's generator,
partial batches as zero-weight rows with the exact weighted-mean gradient,
the val loss and the running best parameters on the device, that many epochs
per captured graph on the card; callbacks, the best checkpoint and the
resume snapshot at call boundaries.  Its trajectory differs from the host
loop's (the device shuffle, the draws' order) and does not depend on
``epochs_per_call``.  Not ported here (ROADMAP.md): the dp×tp mesh (one
device only).
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
from fdtpu_torch.utils.graphs import CudaGraph, GraphRunner, launch_counts, set_counts


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


def _loss_and_update(network, optimizer, scheduler, batch, generator, likelihood_weighting,
                     sample_weight=None):
    """A step's device work: loss, backward, update (no host value)."""
    loss = sde_loss(network, scheduler, batch, generator=generator,
                    likelihood_weighting=likelihood_weighting, train=True,
                    sample_weight=sample_weight)
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


def draw_permutation(n: int, generator: torch.Generator) -> torch.Tensor:
    """A uniform permutation of ``range(n)`` drawn on the generator's device
    (the JAX loop's ``jax.random.permutation``)."""
    return torch.randperm(n, generator=generator, device=generator.device)


def padded_weights(n: int, steps: int, batch: int) -> np.ndarray:
    """(steps, batch) row weights: 1 for the first ``n`` rows, 0 for the
    padding of the last batch (``fdtpu/train/trainer.py:495``)."""
    w = np.zeros((steps * batch,), np.float32)
    w[:n] = 1.0
    return w.reshape(steps, batch)


class ResidentEpochs:
    """Whole epochs on the device (``epochs_per_call``; the JAX package's
    ``_fit_on_device``, ``fdtpu/train/trainer.py:466-620``).

    The standardised train split ``(N, T, C)`` and the val split, padded to
    ``(val steps, B, T, C)``, live on the device.  An epoch draws a
    permutation of the train rows (:func:`draw_permutation`), pads it with row
    0 to whole batches and takes a step on each batch with the rows' weights
    (:func:`padded_weights`: the padding weighs 0, so the loss is the exact
    mean over the real rows and so is its gradient); then the val loss, each
    batch's weighted mean weighted by its real rows, and the running best:
    the parameters, the val loss and the epoch of the best epoch so far, kept
    on the device.  :meth:`run` takes ``n`` epochs and reads their losses and
    the best once.

    On the card the ``n`` epochs are one captured graph, the steps unrolled
    (a draw inside a loop body would repeat its numbers), with the trainer's
    generator registered: one graph per length of call and micro-step
    position that occurs (gradient accumulation bakes whether a micro-step
    updates), captured after one train and one val step warmed the kernels
    up on copies that are then put back.  On the CPU the same epochs run
    directly."""

    def __init__(self, network, optimizer: ClippedAdamW, scheduler: SDE,
                 generator: torch.Generator, likelihood_weighting: bool, train_x: np.ndarray,
                 val_x: np.ndarray, batch: int) -> None:
        self.device = dev = optimizer.params[0].device
        self.network, self.optimizer, self.scheduler = network, optimizer, scheduler
        self.generator, self.likelihood_weighting = generator, likelihood_weighting
        self.n_train, self.batch = len(train_x), batch
        self.steps = -(-self.n_train // batch)
        val_steps = -(-len(val_x) // batch)
        self.x = torch.from_numpy(np.ascontiguousarray(train_x, np.float32)).to(dev)
        xv = np.zeros((val_steps * batch, *val_x.shape[1:]), np.float32)
        xv[:len(val_x)] = val_x
        self.xv = torch.from_numpy(xv.reshape(val_steps, batch, *val_x.shape[1:])).to(dev)
        self.w = torch.from_numpy(padded_weights(self.n_train, self.steps, batch)).to(dev)
        wv = padded_weights(len(val_x), val_steps, batch)
        self.wv = torch.from_numpy(wv).to(dev)
        frac = wv.sum(axis=1)
        self.v_frac = torch.from_numpy(frac / frac.sum()).to(dev)
        self.pad = torch.zeros((self.steps * batch - self.n_train,), dtype=torch.int64, device=dev)
        self.best = [p.detach().clone() for p in optimizer.params]
        self.best_val = torch.full((), float("inf"), device=dev)
        self.best_epoch = torch.full((), -1, dtype=torch.int64, device=dev)
        self.first_epoch = torch.zeros((), dtype=torch.int64, device=dev)
        self.losses: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self.graphs: dict[tuple[int, int], tuple[CudaGraph, tuple[int, ...]]] = {}
        self.pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None

    def start(self, best_val_loss: float) -> None:
        """The running best from the current parameters and ``best_val_loss``
        (a resumed run's), as the JAX carry starts."""
        self.best_val.fill_(best_val_loss)
        self.best_epoch.fill_(-1)
        for b, p in zip(self.best, self.optimizer.params):
            b.copy_(p.detach())

    def run(self, first_epoch: int, n: int) -> tuple[np.ndarray, np.ndarray, float, int]:
        """Epochs ``first_epoch .. first_epoch + n - 1``; returns their step
        losses (n, steps), val losses (n,), the best val loss and its epoch
        (-1: none better than the start), from one device read."""
        if n not in self.losses:
            self.losses[n] = (torch.zeros((n, self.steps), device=self.device),
                              torch.zeros((n,), device=self.device))
        self.first_epoch.fill_(first_epoch)
        if self.pool is None:
            self._epochs(n)
        else:
            self._replay(n)
        steps, vals = self.losses[n]
        values = torch.cat([steps.double().flatten(), vals.double(), self.best_val.double()[None],
                            self.best_epoch.double()[None]]).tolist()
        k = n * self.steps
        return (np.asarray(values[:k]).reshape(n, self.steps), np.asarray(values[k:k + n]),
                values[-2], int(values[-1]))

    def _replay(self, n: int) -> None:
        opt = self.optimizer
        key = (n, opt.mini_step)
        if key not in self.graphs:
            self._warm_up()
            graph = CudaGraph(self.pool, (self.generator,))
            before, host = launch_counts(), (opt.count, opt.mini_step)
            try:
                graph.capture(lambda: self._epochs(n))
                launched = tuple(a - b for a, b in zip(launch_counts(), before))
            finally:
                set_counts(before)
                opt.count, opt.mini_step = host
            self.graphs[key] = (graph, launched)
        graph, launched = self.graphs[key]
        graph.replay()
        set_counts(a + b for a, b in zip(launch_counts(), launched))
        for _ in range(n * self.steps):
            opt.advance()

    def _warm_up(self) -> None:
        """One train step, one val loss and a permutation, eagerly on a side
        stream (kernels built, library handles made), then everything they
        changed put back."""
        opt = self.optimizer
        params = [p.detach().clone() for p in opt.params]
        opt_state = copy.deepcopy(opt.state_dict())
        gen_state, counts = self.generator.get_state(), launch_counts()

        def step():
            draw_permutation(self.n_train, self.generator)
            _loss_and_update(self.network, opt, self.scheduler, self.x[:self.batch],
                             self.generator, self.likelihood_weighting, self.w[0])
            with torch.no_grad():
                sde_loss(self.network, self.scheduler, self.xv[0], generator=self.generator,
                         likelihood_weighting=self.likelihood_weighting, train=False,
                         sample_weight=self.wv[0])

        CudaGraph.warm_up(step)
        with torch.no_grad():
            for p, saved in zip(opt.params, params):
                p.copy_(saved)
        opt.load_state_dict(opt_state)
        self.generator.set_state(gen_state)
        set_counts(counts)

    def _epochs(self, n: int) -> None:
        steps_out, vals_out = self.losses[n]
        opt = self.optimizer
        for e in range(n):
            perm = draw_permutation(self.n_train, self.generator)
            idx = torch.cat([perm, self.pad]).reshape(self.steps, self.batch)
            for s in range(self.steps):
                loss = _loss_and_update(self.network, opt, self.scheduler,
                                        self.x.index_select(0, idx[s]), self.generator,
                                        self.likelihood_weighting, self.w[s])
                steps_out[e, s].copy_(loss)
                opt.advance()
            with torch.no_grad():
                val = torch.stack([
                    sde_loss(self.network, self.scheduler, self.xv[i], generator=self.generator,
                             likelihood_weighting=self.likelihood_weighting, train=False,
                             sample_weight=self.wv[i])
                    for i in range(self.xv.shape[0])])
                val = torch.sum(val * self.v_frac)
                vals_out[e].copy_(val)
                improved = val < self.best_val
                for b, p in zip(self.best, opt.params):
                    b.copy_(torch.where(improved, p, b))
                self.best_val.copy_(torch.minimum(self.best_val, val))
                self.best_epoch.copy_(torch.where(improved, self.first_epoch + e,
                                                  self.best_epoch))


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
        the same for every value.  ``epochs_per_call`` > 1: that many epochs
        per call of the device-resident loop (:class:`ResidentEpochs`; the
        module docstring), ``steps_per_call`` then unused.  ``use_mesh`` on
        one device changes nothing, as with one JAX device; a mesh over
        several devices is not ported yet (ROADMAP.md)."""
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
        self.epochs_per_call = max(1, int(epochs_per_call))
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
        if self.epochs_per_call > 1:
            best_state = self._fit_resident(model, datamodule, network, optimizer, generator,
                                            start_epoch, global_step, best_state)
        else:
            best_state = self._fit_host(model, datamodule, network, optimizer, generator,
                                        start_epoch, global_step, best_state)
        if best_state is not None:
            network.load_state_dict(best_state)
        model.network = network.eval().requires_grad_(False)
        return model

    def _fit_host(self, model, datamodule, network, optimizer, generator, start_epoch,
                  global_step, best_state):
        """The host loop: one host-shuffled epoch after another."""
        device = module_device(network)
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
            self._log_epoch(epoch, global_step, train_loss, val_loss, dt, optimizer)
            if val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                best_state = {k: v.detach().clone() for k, v in network.state_dict().items()}
                self._save_best(model, network, epoch, val_loss)
            self._end_call(network, optimizer, generator, epoch, global_step)
        return best_state

    def _fit_resident(self, model, datamodule, network, optimizer, generator, start_epoch,
                      global_step, best_state):
        """The device-resident loop (``epochs_per_call``; module docstring):
        the logs, the best checkpoint, the resume snapshot and the callbacks
        at each call's end, from one device read."""
        loop = ResidentEpochs(
            network, optimizer, model.scheduler, generator, model.likelihood_weighting,
            datamodule.train_dataloader().dataset.standardized(),
            datamodule.val_dataloader().dataset.standardized(), int(datamodule.batch_size))
        loop.start(self.best_val_loss)
        per_update = self.accumulate_grad_batches
        epoch = start_epoch
        while epoch < self.max_epochs:
            n = min(self.epochs_per_call, self.max_epochs - epoch)
            t0 = time.perf_counter()
            step_losses, val_losses, best_val, best_epoch = loop.run(epoch, n)
            dt = time.perf_counter() - t0
            for e in range(n):
                for loss in step_losses[e]:
                    global_step += 1
                    if global_step % self.log_every_n_steps == 0:
                        self._log({"step": global_step, "epoch": epoch + e,
                                   "train/loss": float(loss),
                                   "lr": optimizer.schedule(global_step // per_update)})
                self._log_epoch(epoch + e, global_step, float(step_losses[e].mean()),
                                float(val_losses[e]), dt / n, optimizer)
            if best_val < self.best_val_loss:
                self.best_val_loss = best_val
                best_state = {k: v.detach().clone() for k, v in network.state_dict().items()}
                # The optimizer's parameters are the network's trainable ones, in order.
                trainable = [n for n, p in network.named_parameters() if p.requires_grad]
                best_state.update({n: b.clone() for n, b in zip(trainable, loop.best)})
                best_network = copy.deepcopy(network)
                best_network.load_state_dict(best_state)
                self._save_best(model, best_network, best_epoch, best_val)
            epoch += n
            self._end_call(network, optimizer, generator, epoch - 1, global_step)
        return best_state

    def _log_epoch(self, epoch, global_step, train_loss, val_loss, dt, optimizer) -> None:
        self._log({"step": global_step, "epoch": epoch, "train/loss_epoch": train_loss,
                   "val/loss": val_loss, "epoch_time_s": round(dt, 2),
                   "lr": optimizer.schedule(global_step // self.accumulate_grad_batches)})
        logging.info("epoch %d: train/loss %.5f val/loss %.5f (%.1fs)",
                     epoch, train_loss, val_loss, dt)

    def _save_best(self, model, network, epoch: int, val_loss: float) -> None:
        self.best_checkpoint = checkpoint.save_checkpoint(
            self.run_dir, dataclasses.replace(model, network=network), epoch, val_loss)
        wandb.maybe_log_model(self.best_checkpoint)

    def _end_call(self, network, optimizer, generator, epoch: int, global_step: int) -> None:
        """The resume snapshot and the callbacks, after ``epoch``."""
        if self.save_resume_state:
            checkpoint.save_train_state(
                self.run_dir,
                {"network": network.state_dict(), "optimizer": optimizer.state_dict(),
                 "generator": generator.get_state()},
                epoch=epoch, global_step=global_step, best_val_loss=self.best_val_loss)
        for callback in self.callbacks:
            callback.on_train_epoch_end(trainer=self, network=network, epoch=epoch)

    def _log(self, record: dict[str, Any]) -> None:
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        wandb.maybe_log_wandb(record)

