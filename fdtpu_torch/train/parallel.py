"""The trainer on a ``("data", "model")`` mesh (the JAX trainer's ``mesh``
and ``use_mesh``, ``fdtpu/train/trainer.py:89-139, 209-218, 287-313,
491-531``).

One process a device.  Every rank holds the whole epoch's batches (the same
loader, the same shuffle), pads each to a multiple of the data axis with
copies of its first row as the JAX trainer does (``pad_to_multiple``; the
device-resident loop pads with zero-weight rows instead) and takes its own
rows.  Every rank draws t, z and the dropout masks of the whole padded batch
from the shared generator and keeps its rows
(:class:`~fdtpu_torch.dist.parallel.ShardedGenerator`), so the draws are the
single device's.

The data axis averages the ranks' gradients, DistributedDataParallel's
arithmetic: after each backward the gradients are flattened, summed over
``mesh["data"]`` by one ``all_reduce`` and divided by its size, before the
clip and the update.  The ``DistributedDataParallel`` module itself is not
used: its reducer fires from autograd hooks, rebuilds its buckets with a
host collective after the first iteration and records timing events, which
the trainer's captured step graphs (``steps_per_call``) and epochs
(``epochs_per_call``) cannot take; one explicit ``all_reduce`` is the same
average and captures as any NCCL collective does.

A rank's loss is its rows' mean; the ranks' mean is the padded batch's mean,
which is the JAX trainer's global loss, and so is the averaged gradient.
With row weights (the resident loop) a rank's loss is ``ranks × Σ_rank w·l
/ max(Σ w, 1)`` over the whole batch's weights, whose ranks' mean is the
weighted mean of the whole batch.  The losses the trainer logs are the
ranks' means, the same on every rank.

The model axis is tensor parallelism (:mod:`fdtpu_torch.dist.tensor_parallel`):
each rank holds its heads and its share of the FFN, the clip's norm sums the
sharded gradients' squares over the axis, and checkpoints and resume
snapshots hold the full parameters (gathered before rank 0 writes them), so a
checkpoint written under a mesh loads without one.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fdtpu_torch.dist import tensor_parallel as tp
from fdtpu_torch.dist.mesh import pad_to_multiple, replicate, tp_parts
from fdtpu_torch.dist.parallel import Axis, ShardedGenerator, gather


class MeshTraining:
    """What the trainer does differently on ``mesh`` (module docstring)."""

    def __init__(self, mesh: DeviceMesh) -> None:
        self.mesh = mesh
        self.data = Axis.of(mesh, "data")
        model = Axis.of(mesh, "model")
        self.model: Optional[Axis] = model if model.size > 1 else None

    # ------------------------------------------------------------ the batch
    def rows(self, batch: np.ndarray) -> np.ndarray:
        """This rank's rows of ``batch`` padded to the data axis."""
        padded, _ = pad_to_multiple(batch, self.data.size)
        return padded[self.data.rows(len(padded))]

    def draws(self, generator: torch.Generator) -> ShardedGenerator:
        return ShardedGenerator(generator, self.data, self.model)

    # ------------------------------------------------------- the parameters
    def place(self, network: torch.nn.Module) -> torch.nn.Module:
        """Rank (0, 0)'s parameters on every rank, then this rank's parts of
        the tensor-parallel ones."""
        replicate(self.mesh, network)
        if self.model is not None:
            tp.parallelize(network, self.model)
        return network

    def grad_norm(self, network: torch.nn.Module):
        """The clip's global norm (None: the optimizer's own, every gradient
        whole on this rank)."""
        if self.model is None:
            return None
        named = [(n, p) for n, p in network.named_parameters() if p.requires_grad]
        return tp.grad_norm_fn([n for n, _ in named], [p for _, p in named], self.model)

    # ------------------------------------------------------------- the step
    def average_gradients(self, params: list[torch.Tensor]) -> None:
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.data.group)
        flat.div_(self.data.size)
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])

    def global_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The ranks' mean of a rank's loss (module docstring)."""
        return torch.mean(gather(loss, self.data.group))

    # ---------------------------------------------------------- full states
    def full_state(self, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return state if self.model is None else tp.full_state(state, self.model)

    def local_state(self, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return state if self.model is None else tp_parts(state, self.model.size, self.model.index)

    def full_network(self, template: torch.nn.Module, network: torch.nn.Module,
                     state: Optional[dict] = None) -> torch.nn.Module:
        """``network`` (or its ``state``) with full parameters, in a copy of
        the full-shape ``template``; ``network`` itself without a model axis
        and no ``state``."""
        if self.model is None and state is None:
            return network
        full = copy.deepcopy(template)
        full.load_state_dict(self.full_state(state if state is not None
                                             else network.state_dict()))
        return full

    def full_optimizer_state(self, state: dict, names: list[str]) -> dict:
        """The optimizer's state with its per-parameter lists full."""
        return self._map_lists(state, names, self.full_state)

    def local_optimizer_state(self, state: dict, names: list[str]) -> dict:
        return self._map_lists(state, names, self.local_state)

    def _map_lists(self, state: dict, names: list[str], fn) -> dict:
        if self.model is None:
            return state
        out = dict(state)
        for key, value in state.items():
            if isinstance(value, list):
                mapped = fn(dict(zip(names, value)))
                out[key] = [mapped[n] for n in names]
        return out
