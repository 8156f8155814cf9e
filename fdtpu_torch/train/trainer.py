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
``epochs_per_call``.

The loop's regions are spans of :mod:`fdtpu_torch.utils.profiling`
(``fdtpu.fit`` and its ``fdtpu.fit.*`` children: epoch, batches, chunk,
steps, train loss, resident, and the epoch end, everything after the loss
read: validation, checkpoint, resume state, callbacks); they record nothing
unless a recording is open or the profiler runs.

``mesh`` / ``use_mesh``: data parallelism over the mesh's ``data`` axis and
tensor parallelism over its ``model`` axis, one process a device
(:mod:`fdtpu_torch.train.parallel`), with every path above; only rank 0
writes the run's files.
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
import torch.distributed as dist

from fdtpu_torch.diffusion.losses import sde_loss
from fdtpu_torch.diffusion.sde import SDE
from fdtpu_torch.dist.parallel import writes
from fdtpu_torch.models.score_models import ScoreModel, ScoreNetwork
from fdtpu_torch.train import checkpoint
from fdtpu_torch.train.parallel import MeshTraining
from fdtpu_torch.train.state import ClippedAdamW, make_optimizer
from fdtpu_torch.utils import wandb
from fdtpu_torch.utils.device import module_device
from fdtpu_torch.utils.graphs import CudaGraph, GraphRunner, add_counts, uncounted
from fdtpu_torch.utils.profiling import span


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
                     sample_weight=None, mesh: Optional[MeshTraining] = None,
                     weight_total=None):
    """A step's device work: loss, backward, update (no host value).  On a
    ``mesh``, ``batch`` and ``sample_weight`` are this rank's rows and
    ``weight_total`` the whole batch's ``Σ w``; the loss returned is the
    whole batch's (:mod:`fdtpu_torch.train.parallel`)."""
    if mesh is None:
        loss = sde_loss(network, scheduler, batch, generator=generator,
                        likelihood_weighting=likelihood_weighting, train=True,
                        sample_weight=sample_weight)
        optimizer.zero_grad()
        loss.backward()
        optimizer.update()
        return loss.detach()
    loss = _mesh_loss(network, scheduler, batch, generator, likelihood_weighting, mesh, True,
                      sample_weight, weight_total)
    optimizer.zero_grad()
    loss.backward()
    mesh.average_gradients(optimizer.params)
    optimizer.update()
    return mesh.global_loss(loss.detach())


def _mesh_loss(network, scheduler, batch, generator, likelihood_weighting, mesh, train,
               sample_weight=None, weight_total=None):
    """A rank's loss, whose ranks' mean is the whole batch's loss (with
    row weights, the rank's weighted sum over the whole batch's weights,
    times the ranks)."""
    loss = sde_loss(network, scheduler, batch, generator=mesh.draws(generator),
                    likelihood_weighting=likelihood_weighting, train=train,
                    sample_weight=sample_weight, weight_total=weight_total)
    return loss if sample_weight is None else loss * mesh.data.size


def _trainable(network) -> list[str]:
    """The names of the network's trainable parameters: the optimizer's, in order."""
    return [n for n, p in network.named_parameters() if p.requires_grad]


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
                 generator: torch.Generator, likelihood_weighting: bool, capacity: int,
                 mesh: Optional[MeshTraining] = None) -> None:
        self.network = network
        self.mesh = mesh
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
        with span("fdtpu.fit.chunk"):
            chunk[:n].copy_(torch.from_numpy(np.stack(batches)))
        with span("fdtpu.fit.steps"):
            j.zero_()
            for _ in range(n):
                self.runner.run((shape, self.optimizer.emits),
                                lambda: self._step(chunk, losses, j))
                self.optimizer.advance()
            return losses[:n].clone()

    def _step(self, chunk: torch.Tensor, losses: torch.Tensor, j: torch.Tensor) -> None:
        loss = _loss_and_update(self.network, self.optimizer, self.scheduler,
                                chunk.index_select(0, j)[0], self.generator,
                                self.likelihood_weighting, mesh=self.mesh)
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
    directly.

    On a ``mesh`` every rank holds the whole train split and draws the same
    permutation; each batch is padded with zero-weight rows (row 0) to a
    multiple of the data axis, as the JAX loop pads to ``B_pad``, and each
    rank takes its rows of it, of the val batches and of their weights."""

    def __init__(self, network, optimizer: ClippedAdamW, scheduler: SDE,
                 generator: torch.Generator, likelihood_weighting: bool, train_x: np.ndarray,
                 val_x: np.ndarray, batch: int, mesh: Optional[MeshTraining] = None) -> None:
        self.device = dev = optimizer.params[0].device
        self.network, self.optimizer, self.scheduler = network, optimizer, scheduler
        self.generator, self.likelihood_weighting = generator, likelihood_weighting
        self.mesh = mesh
        self.n_train, self.batch = len(train_x), batch
        self.steps = -(-self.n_train // batch)
        val_steps = -(-len(val_x) // batch)
        self.x = torch.from_numpy(np.ascontiguousarray(train_x, np.float32)).to(dev)
        xv = np.zeros((val_steps * batch, *val_x.shape[1:]), np.float32)
        xv[:len(val_x)] = val_x
        xv = xv.reshape(val_steps, batch, *val_x.shape[1:])
        w = padded_weights(self.n_train, self.steps, batch)
        wv = padded_weights(len(val_x), val_steps, batch)
        frac = wv.sum(axis=1)
        if mesh is not None:
            # The whole padded batch's Σ w, then this rank's rows of each batch.
            self.batch_pad = -(-batch // mesh.data.size) * mesh.data.size
            self.cols = mesh.data.rows(self.batch_pad)
            xv, w, wv = (self._pad_cols(a) for a in (xv, w, wv))
            self.w_total = torch.from_numpy(w.sum(axis=1)).to(dev)
            self.wv_total = torch.from_numpy(wv.sum(axis=1)).to(dev)
            xv, w, wv = (np.ascontiguousarray(a[:, self.cols]) for a in (xv, w, wv))
        self.xv = torch.from_numpy(xv).to(dev)
        self.w = torch.from_numpy(w).to(dev)
        self.wv = torch.from_numpy(wv).to(dev)
        self.v_frac = torch.from_numpy(frac / frac.sum()).to(dev)
        self.pad = torch.zeros((self.steps * batch - self.n_train,), dtype=torch.int64, device=dev)
        self.best = [p.detach().clone() for p in optimizer.params]
        self.best_val = torch.full((), float("inf"), device=dev)
        self.best_epoch = torch.full((), -1, dtype=torch.int64, device=dev)
        self.first_epoch = torch.zeros((), dtype=torch.int64, device=dev)
        self.losses: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self.graphs: dict[tuple[int, int], tuple[CudaGraph, tuple[int, ...]]] = {}
        self.pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None

    def _pad_cols(self, a: np.ndarray) -> np.ndarray:
        """(steps, B, …) padded with zeros to (steps, B_pad, …)."""
        pad = self.batch_pad - a.shape[1]
        return np.concatenate([a, np.zeros((a.shape[0], pad, *a.shape[2:]), a.dtype)], axis=1)

    def _train_step(self, rows: torch.Tensor, s):
        """One optimizer step on train rows ``rows`` with batch ``s``'s weights."""
        return _loss_and_update(self.network, self.optimizer, self.scheduler,
                                self.x.index_select(0, rows), self.generator,
                                self.likelihood_weighting, self.w[s], self.mesh,
                                None if self.mesh is None else self.w_total[s])

    def _val_loss(self, i) -> torch.Tensor:
        """The weighted val loss of val batch ``i`` (the whole batch's)."""
        if self.mesh is None:
            return sde_loss(self.network, self.scheduler, self.xv[i], generator=self.generator,
                            likelihood_weighting=self.likelihood_weighting, train=False,
                            sample_weight=self.wv[i])
        loss = _mesh_loss(self.network, self.scheduler, self.xv[i], self.generator,
                          self.likelihood_weighting, self.mesh, False, self.wv[i],
                          self.wv_total[i])
        return self.mesh.global_loss(loss)

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
            host = (opt.count, opt.mini_step)
            try:
                with uncounted() as launched:
                    graph.capture(lambda: self._epochs(n))
            finally:
                opt.count, opt.mini_step = host
            self.graphs[key] = (graph, tuple(launched))
        graph, launched = self.graphs[key]
        graph.replay()
        add_counts(launched)
        for _ in range(n * self.steps):
            opt.advance()

    def _warm_up(self) -> None:
        """One train step, one val loss and a permutation, eagerly on a side
        stream (kernels built, library handles made), then everything they
        changed put back."""
        opt = self.optimizer
        params = [p.detach().clone() for p in opt.params]
        opt_state = copy.deepcopy(opt.state_dict())
        gen_state = self.generator.get_state()

        def step():
            draw_permutation(self.n_train, self.generator)
            self._train_step(torch.zeros(self.w.shape[1], dtype=torch.int64,
                                         device=self.device), 0)
            with torch.no_grad():
                self._val_loss(0)

        with uncounted():
            CudaGraph.warm_up(step)
        with torch.no_grad():
            for p, saved in zip(opt.params, params):
                p.copy_(saved)
        opt.load_state_dict(opt_state)
        self.generator.set_state(gen_state)

    def _epochs(self, n: int) -> None:
        steps_out, vals_out = self.losses[n]
        opt = self.optimizer
        for e in range(n):
            perm = draw_permutation(self.n_train, self.generator)
            idx = torch.cat([perm, self.pad]).reshape(self.steps, self.batch)
            if self.mesh is not None:
                # Zero-weight row-0 padding to B_pad, then this rank's rows.
                idx = torch.nn.functional.pad(idx, (0, self.batch_pad - self.batch))[:, self.cols]
            for s in range(self.steps):
                steps_out[e, s].copy_(self._train_step(idx[s], s))
                opt.advance()
            with torch.no_grad():
                val = torch.stack([self._val_loss(i) for i in range(self.xv.shape[0])])
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
        module docstring), ``steps_per_call`` then unused.

        ``mesh``: a torch ``DeviceMesh`` with ``("data", "model")`` axes
        (:func:`fdtpu_torch.dist.create_mesh`) to train over, every rank
        calling :meth:`fit` alike: the batch sharded over ``data``, the
        attention and FFN tensor-parallel over ``model``
        (:mod:`fdtpu_torch.train.parallel`).  ``use_mesh=True`` with no
        ``mesh`` takes a data-only mesh over the initialized world when it
        has more than one process (``torchrun``), as the JAX trainer's
        default mesh spans every device; in one process it changes nothing,
        as with one JAX device.  Constructed in a world of more than one
        process (every rank alike), it takes rank 0's ``run_id``."""
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a torch DeviceMesh (fdtpu_torch.dist.create_mesh), "
                                f"got {type(mesh).__name__}")
        self.mesh = mesh
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
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            # Every rank of a world writes under rank 0's run id.
            names = [self.run_id]
            dist.broadcast_object_list(names, src=0)
            self.run_id = names[0]
        self.run_dir = Path(run_dir) / self.run_id
        if writes():
            self.run_dir.mkdir(parents=True, exist_ok=True)
        self.metrics_path = self.run_dir / "metrics.jsonl"
        self.best_val_loss = float("inf")
        self.best_checkpoint: Optional[Path] = None
        self._mesh: Optional[MeshTraining] = None

    def _resolve_mesh(self, device: torch.device) -> Optional[MeshTraining]:
        """The mesh to train on (class docstring)."""
        mesh = self.mesh
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        if mesh is None and self.use_mesh and world > 1:
            from fdtpu_torch.dist import create_mesh

            mesh = create_mesh(device_type=device.type)
        if mesh is None:
            if self.use_mesh and device.type == "cuda" and torch.cuda.device_count() > 1:
                logging.info("use_mesh: no process group, so no mesh; training on %s "
                             "(run one process a card, e.g. under torchrun, for a "
                             "data-parallel mesh)", device)
            return None
        return MeshTraining(mesh)

    def fit(self, model: ScoreModel, datamodule: Any) -> ScoreModel:
        """Train a copy of ``model.network``; set ``model.network`` to the
        best-val parameters, frozen, and return ``model``."""
        with span("fdtpu.fit", epochs=self.max_epochs):
            return self._fit(model, datamodule)

    def _fit(self, model: ScoreModel, datamodule: Any) -> ScoreModel:
        device = module_device(model.network)
        mesh = self._mesh = self._resolve_mesh(device)
        network = copy.deepcopy(model.network).train().requires_grad_(True)
        if mesh is not None:
            if mesh.model is not None:
                from fdtpu_torch.dist.mesh import check_model_axis

                check_model_axis(mesh.model.size, model.config.n_head,
                                 model.config.dim_feedforward)
            mesh.place(network)
        generator = torch.Generator(device=device).manual_seed(self.seed)
        optimizer = make_optimizer(
            network.parameters(), model.lr_max, model.num_training_steps,
            gradient_clip_val=self.gradient_clip_val,
            accumulate_grad_batches=self.accumulate_grad_batches,
            grad_norm=None if mesh is None else mesh.grad_norm(network),
        )
        best_state: Optional[dict[str, torch.Tensor]] = None
        start_epoch = global_step = 0
        if self.resume:
            restored = checkpoint.load_train_state(self.run_dir)
            if restored is not None:
                state, meta = restored
                network.load_state_dict(self._local(state["network"]))
                optimizer.load_state_dict(
                    state["optimizer"] if mesh is None else
                    mesh.local_optimizer_state(state["optimizer"], _trainable(network)))
                generator.set_state(state["generator"])
                start_epoch = int(meta["epoch"]) + 1
                global_step = int(meta["global_step"])
                self.best_val_loss = float(meta["best_val_loss"])
                ckpts = self.run_dir / "checkpoints"
                if any(ckpts.glob("*.ckpt")):
                    self.best_checkpoint = checkpoint.get_best_checkpoint(ckpts)
                    best_state = self._local(checkpoint.load_network_state(self.best_checkpoint))
                logging.info("resuming from epoch %d (global step %d)", start_epoch, global_step)
        if self.epochs_per_call > 1:
            best_state = self._fit_resident(model, datamodule, network, optimizer, generator,
                                            start_epoch, global_step, best_state)
        else:
            best_state = self._fit_host(model, datamodule, network, optimizer, generator,
                                        start_epoch, global_step, best_state)
        if best_state is not None:
            network.load_state_dict(best_state)
        if mesh is not None:
            network = mesh.full_network(model.network, network)
        model.network = network.eval().requires_grad_(False)
        return model

    def _local(self, state: dict) -> dict:
        """This rank's parts of a full network state (the state itself
        without a model axis)."""
        return state if self._mesh is None else self._mesh.local_state(state)

    def _fit_host(self, model, datamodule, network, optimizer, generator, start_epoch,
                  global_step, best_state):
        """The host loop: one host-shuffled epoch after another."""
        device = module_device(network)
        scheduler = model.scheduler
        spc = self.steps_per_call
        mesh = self._mesh
        graphed = (GraphedSteps(network, optimizer, scheduler, generator,
                                model.likelihood_weighting, spc, mesh) if spc > 1 else None)
        train_loader = datamodule.train_dataloader()
        if start_epoch:
            train_loader.skip_epochs(start_epoch)
        val_sizes, val_batches = [], []
        for b in datamodule.val_dataloader():
            val_sizes.append(len(b))
            val_batches.append(torch.from_numpy(b if mesh is None else mesh.rows(b)).to(device))
        per_update = self.accumulate_grad_batches

        for epoch in range(start_epoch, self.max_epochs):
            with span("fdtpu.fit.epoch", epoch=epoch):
                t0 = time.perf_counter()
                losses = []
                with span("fdtpu.fit.batches"):
                    batches = list(train_loader)
                    if mesh is not None:
                        batches = [mesh.rows(b) for b in batches]
                for i, run in group_same_shape(batches, spc):
                    if graphed is None:
                        with span("fdtpu.fit.chunk"):
                            xb = torch.from_numpy(batches[i]).to(device)
                        with span("fdtpu.fit.steps"):
                            step_losses = _loss_and_update(
                                network, optimizer, scheduler, xb, generator,
                                model.likelihood_weighting, mesh=mesh).reshape(1)
                            optimizer.advance()
                    else:
                        step_losses = graphed.run(batches[i:i + run])
                    losses.append(step_losses)
                    for off in range(run):
                        global_step += 1
                        if global_step % self.log_every_n_steps == 0:
                            self._log({"step": global_step, "epoch": epoch,
                                       "train/loss": float(step_losses[off]),
                                       "lr": optimizer.schedule(global_step // per_update)})
                with span("fdtpu.fit.train_loss"):
                    train_loss = float(torch.cat(losses).mean())

                with span("fdtpu.fit.epoch_end", epoch=epoch):
                    with span("fdtpu.fit.validation"), torch.no_grad():
                        val_losses = [
                            sde_loss(network, scheduler, xb, generator=generator,
                                     likelihood_weighting=model.likelihood_weighting,
                                     train=False)
                            if mesh is None else
                            mesh.global_loss(_mesh_loss(network, scheduler, xb, generator,
                                                        model.likelihood_weighting, mesh, False))
                            for xb in val_batches
                        ]
                        val_loss = (
                            float(np.average(torch.stack(val_losses).cpu().numpy(),
                                             weights=val_sizes))
                            if val_losses else float("nan")
                        )
                    dt = time.perf_counter() - t0
                    self._log_epoch(epoch, global_step, train_loss, val_loss, dt, optimizer)
                    if val_loss < self.best_val_loss:
                        self.best_val_loss = val_loss
                        best_state = {k: v.detach().clone()
                                      for k, v in network.state_dict().items()}
                        self._save_best(model, network, epoch, val_loss)
                    self._end_call(model, network, optimizer, generator, epoch, global_step)
        return best_state

    def _fit_resident(self, model, datamodule, network, optimizer, generator, start_epoch,
                      global_step, best_state):
        """The device-resident loop (``epochs_per_call``; module docstring):
        the logs, the best checkpoint, the resume snapshot and the callbacks
        at each call's end, from one device read."""
        loop = ResidentEpochs(
            network, optimizer, model.scheduler, generator, model.likelihood_weighting,
            datamodule.train_dataloader().dataset.standardized(),
            datamodule.val_dataloader().dataset.standardized(), int(datamodule.batch_size),
            self._mesh)
        loop.start(self.best_val_loss)
        per_update = self.accumulate_grad_batches
        epoch = start_epoch
        while epoch < self.max_epochs:
            n = min(self.epochs_per_call, self.max_epochs - epoch)
            t0 = time.perf_counter()
            with span("fdtpu.fit.resident", epoch=epoch, epochs=n):
                step_losses, val_losses, best_val, best_epoch = loop.run(epoch, n)
            dt = time.perf_counter() - t0
            with span("fdtpu.fit.epoch_end", epoch=epoch + n - 1):
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
                    best_state.update({n: b.clone()
                                       for n, b in zip(_trainable(network), loop.best)})
                    self._save_best(model, network, best_epoch, best_val, best_state)
                epoch += n
                self._end_call(model, network, optimizer, generator, epoch - 1, global_step)
        return best_state

    def _log_epoch(self, epoch, global_step, train_loss, val_loss, dt, optimizer) -> None:
        self._log({"step": global_step, "epoch": epoch, "train/loss_epoch": train_loss,
                   "val/loss": val_loss, "epoch_time_s": round(dt, 2),
                   "lr": optimizer.schedule(global_step // self.accumulate_grad_batches)})
        logging.info("epoch %d: train/loss %.5f val/loss %.5f (%.1fs)",
                     epoch, train_loss, val_loss, dt)

    def _full(self, model, network, state: Optional[dict] = None):
        """``network`` (with ``state`` loaded, if given) with full
        parameters: a gather over the model axis, which every rank joins."""
        if self._mesh is not None:
            return self._mesh.full_network(model.network, network, state)
        if state is None:
            return network
        network = copy.deepcopy(network)
        network.load_state_dict(state)
        return network

    def _save_best(self, model, network, epoch: int, val_loss: float,
                   state: Optional[dict] = None) -> None:
        with span("fdtpu.fit.checkpoint", epoch=epoch):
            network = self._full(model, network, state)
            if not writes():
                return
            self.best_checkpoint = checkpoint.save_checkpoint(
                self.run_dir, dataclasses.replace(model, network=network), epoch, val_loss)
            wandb.maybe_log_model(self.best_checkpoint)

    def _end_call(self, model, network, optimizer, generator, epoch: int,
                  global_step: int) -> None:
        """The resume snapshot and the callbacks, after ``epoch`` (rank 0
        alone on a mesh, with the full parameters)."""
        mesh = self._mesh
        if self.save_resume_state:
            with span("fdtpu.fit.resume_state", epoch=epoch):
                opt_state = optimizer.state_dict()
                if mesh is not None:
                    opt_state = mesh.full_optimizer_state(opt_state, _trainable(network))
                state = {"network": self._full(model, network).state_dict(),
                         "optimizer": opt_state, "generator": generator.get_state()}
                if writes():
                    checkpoint.save_train_state(self.run_dir, state, epoch=epoch,
                                                global_step=global_step,
                                                best_val_loss=self.best_val_loss)
        if self.callbacks:
            with span("fdtpu.fit.callbacks", epoch=epoch):
                full = self._full(model, network)
                if writes():
                    for callback in self.callbacks:
                        callback.on_train_epoch_end(trainer=self, network=full, epoch=epoch)

    def _log(self, record: dict[str, Any]) -> None:
        if not writes():
            return
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        wandb.maybe_log_wandb(record)

