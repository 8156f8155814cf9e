"""Device mesh and placements — the port's communication backend (port of
``fdtpu/dist/mesh.py``).

The JAX module is single-controller SPMD: one program sees every chip, a
``jax.sharding.Mesh`` names their axes, a ``NamedSharding`` (a
``PartitionSpec`` over those names) places each array, and XLA inserts the
collectives.  Torch's idiom is multi-process SPMD: one process a device, a
``torch.distributed`` process group over them, and a
:class:`~torch.distributed.device_mesh.DeviceMesh` whose dimensions are
process groups.  The names map as:

* ``Mesh(devices, ("data", "model"))`` → :func:`create_mesh`, a
  ``DeviceMesh`` with ``mesh_dim_names=("data", "model")`` over the
  initialized world (``torchrun``, or ``init_process_group`` with a store);
* ``PartitionSpec`` → a DTensor placement a mesh dimension:
  ``P("data", None, …)`` is ``(Shard(0), Replicate())``, ``P()`` is
  ``(Replicate(), Replicate())``;
* ``device_put(x, sharding)`` → this rank's part of ``x``: the rows of its
  ``data`` coordinate (:func:`shard_batch`), the whole of a replicated array
  (:func:`replicate`, which makes every rank hold the first rank's values),
  the slices of its ``model`` coordinate for a tensor-parallel parameter
  (:func:`shard_params`);
* the collectives XLA would insert are written out where the port needs
  them (:mod:`fdtpu_torch.dist.parallel`).

Training and sampling are data-parallel over the batch axis; the ``model``
axis carries the trainer's tensor parallelism (:func:`tp_param_spec`).  The
JAX spec splits the in-projection ``(L, D, 3D)`` contiguously over its 3D
axis, so at tp = 2 one device holds all of q and half of k, and XLA reshards
before attention.  The port places it per head: each rank holds the q, k
and v rows of its ``H / tp`` heads (the ``(3D, D)`` weight seen as ``(3, D,
D)``, split on the middle axis), so the attention kernel runs on whole local
heads with no resharding; the values are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

from fdtpu_torch.dist.parallel import Axis

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh layout: ``data`` shards the batch axis, ``model`` is the
    trainer's tensor parallelism (default 1 — the score nets are ~3 M
    params)."""

    data: int = -1  # -1 → all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(f"Mesh {data}x{model} does not cover {n_devices} devices")
        return data, model


def check_model_axis(model: int, n_head: int, dim_feedforward: int) -> None:
    """A ``model`` axis of ``model`` ranks must split the heads and the FFN
    width evenly: each rank runs whole heads and an equal share of the FFN."""
    if n_head % model or dim_feedforward % model:
        raise ValueError(
            f"a model axis of {model} does not divide n_head {n_head} and dim_feedforward "
            f"{dim_feedforward}")


def create_mesh(config: Optional[MeshConfig] = None,
                device_type: Optional[str] = None) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the initialized world: ``data ×
    model`` must cover every process.  ``device_type`` defaults to ``cuda``
    (NCCL); ``"cpu"`` takes a gloo world.  Without an initialized process
    group it raises: it never makes a one-device mesh on its own."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "create_mesh needs an initialized process group: run under torchrun, or call "
            "torch.distributed.init_process_group(backend, init_method=..., rank=..., "
            "world_size=...) first (a one-process world too)")
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_mesh(device_type='cuda') with no CUDA device; pass "
                           "device_type='cpu' for a gloo world")
    data, model = (config or MeshConfig()).resolve(dist.get_world_size())
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def data_sharding(mesh: DeviceMesh, ndim: int) -> tuple[Placement, ...]:
    """Shard the leading (batch) axis over ``data``, replicate the rest."""
    if ndim < 1:
        raise ValueError("a batch has a leading axis")
    return (Shard(0), Replicate())


def shard_batch(mesh: DeviceMesh, batch: Any) -> Any:
    """This rank's rows of a batch (a tensor, or a dict, list or tuple of
    them) under :func:`data_sharding`.  The leading dim must divide by the
    data-axis size."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    batch = torch.as_tensor(batch)
    return batch[Axis.of(mesh, "data").rows(batch.shape[0])]


@torch.no_grad()
def replicate(mesh: DeviceMesh, tree: Any) -> Any:
    """Make every rank of the mesh hold its first rank's values of each
    tensor in ``tree`` (a tensor, a module's parameters, or a dict, list or
    tuple of tensors), in place; returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        replicate(mesh, list(tree.parameters()) + list(tree.buffers()))
        return tree
    if isinstance(tree, dict):
        replicate(mesh, list(tree.values()))
        return tree
    if isinstance(tree, (list, tuple)):
        for t in tree:
            replicate(mesh, t)
        return tree
    # The model axis's first rank, then the data axis's: rank (0, 0)'s values.
    for name in reversed(AXES):
        group = mesh.get_group(name)
        dist.broadcast(tree, dist.get_global_rank(group, 0), group=group)
    return tree


def tp_param_spec(name: str, param: torch.Tensor) -> tuple[Placement, int]:
    """Megatron-style placement of one of the port's transformer parameters
    over the ``model`` axis, and the number of equal blocks its sharded dim
    is seen as (the in-projection's q, k and v: 3; else 1).

    Column-parallel in-projection and ``linear1`` (the output features:
    ``in_proj_weight`` (3D, D) per head, ``linear1.weight`` (F, D) and their
    biases), row-parallel ``out_proj`` and ``linear2`` (the input features:
    (D, D) and (D, F)); everything else (embeddings, norms, the biases of the
    row-parallel layers) replicated.  A torch ``Linear`` keeps (out, in), so
    the JAX spec's last axis of (L, D, 3D) is dim 0 here."""
    del param
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
    if leaf in ("in_proj_weight", "in_proj_bias"):
        return Shard(0), 3
    if owner == "linear1" and leaf in ("weight", "bias"):
        return Shard(0), 1
    if owner in ("out_proj", "linear2") and leaf == "weight":
        return Shard(1), 1
    return Replicate(), 1


def tp_slice(x: torch.Tensor, placement: Placement, blocks: int, size: int,
             index: int) -> torch.Tensor:
    """Rank ``index`` of ``size``'s part of the full ``x`` under
    ``(placement, blocks)`` (:func:`tp_param_spec`)."""
    if not isinstance(placement, Shard) or size == 1:
        return x
    d = placement.dim
    n = x.shape[d] // blocks
    if n % size:
        raise ValueError(f"dim {d} of {tuple(x.shape)} does not split over {size} ranks")
    view = x.unflatten(d, (blocks, n))
    part = view.narrow(d + 1, index * (n // size), n // size)
    return part.flatten(d, d + 1).contiguous()


def tp_join(parts: list[torch.Tensor], placement: Placement, blocks: int) -> torch.Tensor:
    """The full tensor from every rank's part (inverse of :func:`tp_slice`)."""
    if not isinstance(placement, Shard) or len(parts) == 1:
        return parts[0]
    d = placement.dim
    views = [p.unflatten(d, (blocks, p.shape[d] // blocks)) for p in parts]
    return torch.cat(views, dim=d + 1).flatten(d, d + 1)


def shard_params(mesh: DeviceMesh, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Place a ``{name: tensor}`` of full parameters on the mesh: this rank's
    tensor-parallel parts (:func:`tp_param_spec`) when the ``model`` axis has
    more than one rank, the tensors themselves (replicated) otherwise."""
    model = Axis.of(mesh, "model")
    return tp_parts(params, model.size, model.index)


def tp_parts(params: dict[str, torch.Tensor], size: int, index: int) -> dict[str, torch.Tensor]:
    """Rank ``index`` of a model axis of ``size``'s parts of full parameters
    (:func:`tp_param_spec`, :func:`tp_slice`)."""
    if size <= 1:
        return dict(params)
    return {name: tp_slice(p, *tp_param_spec(name, p), size, index)
            for name, p in params.items()}


def pad_to_multiple(batch: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the batch axis up to a multiple (for even sharding) with copies of
    the first row; returns (padded, original_size)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    pad = np.repeat(batch[:1], rem, axis=0)
    return np.concatenate([batch, pad], axis=0), n
