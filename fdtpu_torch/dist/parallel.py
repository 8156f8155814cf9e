"""The collectives of the port's data and model axes.

Under a JAX mesh an array is one global value; XLA inserts the collectives a
reduction over a sharded axis needs.  The port runs one process a device, so
each reduction over the sample batch writes its collective out.  The rule is
in one place, these helpers, each taking an optional process group: with
``group=None`` a helper is the plain single-device call (its values bitwise
what they were before the mesh existed); with a group, the reduction of the
*global* batch:

* :func:`batch_mean` — each rank reduces its rows, the ranks' results are
  gathered, and their mean is taken (every rank holds an equal share of the
  batch, so the mean of the ranks' means is the global mean);
* :func:`batch_norm` — the L2 norm of the ranks' gathered norms;
* :func:`batch_first` — a value computed from the global batch's first
  sample (the KV level's CRF), broadcast from the rank that holds it.

Gathering the ranks' partial results and reducing them in rank order on
every rank (rather than an ``all_reduce``) gives every rank the same bits,
so decisions taken on them agree everywhere; and at world size 1 the
reduction of one part is that part (a mean over one element divides by 1, the
norm of one norm is that norm exactly), so a one-rank mesh reproduces the
unmeshed values bitwise while still running every collective.

Random draws: a rank draws the *global* batch's numbers from the shared
generator, in the single-device order, and takes its rows (and its columns,
for a column-parallel activation) — :class:`ShardedGenerator` and
:func:`draw`.  Per-rank generators would give other samples.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed import ProcessGroup

Group = Optional[ProcessGroup]

# ``all_gather_into_tensor`` was renamed; take whichever this torch has.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def gather(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: ``(ranks, *x.shape)``."""
    ranks = dist.get_world_size(group)
    out = torch.empty((ranks * x.numel(),), dtype=x.dtype, device=x.device)
    _all_gather(out, x.contiguous().reshape(-1), group=group)
    return out.view(ranks, *x.shape)


def batch_mean(x: torch.Tensor, dim, group: Group = None) -> torch.Tensor:
    """``torch.mean(x, dim)`` over dims that include the batch axis 0, over
    the global batch."""
    m = torch.mean(x, dim=dim)
    if group is None:
        return m
    return torch.mean(gather(m, group), dim=0)


def batch_norm(x: torch.Tensor, dim=None, group: Group = None) -> torch.Tensor:
    """``torch.linalg.vector_norm(x, dim=dim)`` over dims that include the
    batch axis 0 (all of them for ``dim=None``), over the global batch."""
    n = torch.linalg.vector_norm(x, dim=dim)
    if group is None:
        return n
    return torch.linalg.vector_norm(gather(n, group), dim=0)


def batch_first(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """``x`` as the group's first rank computed it (the one that holds the
    global batch's first sample)."""
    if group is None:
        return x
    x = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(x, dist.get_global_rank(group, 0), group=group)
    return x


def writes() -> bool:
    """Whether this process writes a run's files: rank 0 of an initialized
    world, or the one process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def gather_batch(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """The global batch from every rank's rows (concatenated on axis 0)."""
    if group is None:
        return x
    return gather(x, group).flatten(0, 1)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh, as this rank sees it: its process group, its
    size and this rank's coordinate."""

    group: ProcessGroup
    size: int
    index: int

    @classmethod
    def of(cls, mesh, name: str) -> "Axis":
        return cls(mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)),
                   mesh.get_local_rank(name))

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (a multiple of size)."""
        if n % self.size:
            raise ValueError(f"batch of {n} does not split over a data axis of {self.size}")
        part = n // self.size
        return slice(self.index * part, (self.index + 1) * part)


@dataclasses.dataclass(frozen=True)
class ShardedGenerator:
    """A generator shared by every rank, drawing for one rank of a mesh:
    :func:`draw` of a local shape ``(n, …)`` draws the global ``(n × data
    ranks, …)`` and returns this rank's rows; with ``cols`` (a
    column-parallel activation) the last dim is also the ``model`` rank's
    part of ``last × model ranks``."""

    generator: torch.Generator
    data: Axis
    model: Optional[Axis] = None

    def draw(self, sample: Callable, shape, device, dtype=None, cols: bool = False):
        shape = tuple(shape)
        size = (self.data.size * shape[0], *shape[1:])
        split = cols and self.model is not None and self.model.size > 1
        if split:
            size = (*size[:-1], size[-1] * self.model.size)
        out = sample(size, generator=self.generator, device=device, dtype=dtype)
        out = out[self.data.rows(size[0])]
        if split:
            n = shape[-1]
            out = out[..., self.model.index * n:(self.model.index + 1) * n]
        return out


def draw(sample: Callable, shape, generator, device, dtype=None, cols: bool = False):
    """``sample(shape, generator=generator, …)`` (``torch.rand`` or
    ``torch.randn``); a :class:`ShardedGenerator` draws the global batch and
    returns this rank's part."""
    if isinstance(generator, ShardedGenerator):
        return generator.draw(sample, shape, device, dtype, cols)
    return sample(tuple(shape), generator=generator, device=device, dtype=dtype)
