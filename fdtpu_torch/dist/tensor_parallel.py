"""Tensor parallelism of the transformer score network over a mesh's
``model`` axis (the JAX trainer's ``shard_params`` with
:func:`~fdtpu_torch.dist.mesh.tp_param_spec`, where XLA inserts the
collectives; here they are written out, Megatron's way).

:func:`parallelize` gives each encoder layer this rank's parts of its
parameters: the q, k and v rows of its ``H / tp`` heads, its share of the
FFN's hidden units, the matching input columns of ``out_proj`` and
``linear2``.  The layer then runs (``EncoderLayer._to_model``,
``EncoderLayer._row``):

* the column-parallel projections on :func:`copy_to_model` of their input —
  the identity forward, the ranks' gradients summed backward;
* attention on its local heads — kernel B1 (B2 backward) on ``(B, T, D /
  tp)`` queries and ``H / tp`` heads of keys and values, no resharding;
* the row-parallel projections as partial products summed over the ranks
  (:func:`reduce_from_model`, an ``all_reduce`` forward, the identity
  backward), then the bias.

Everything else is replicated, and its gradient is the same on every rank of
the axis.  :func:`full_state` gathers the parts back into the full
parameters (the checkpoint layout; :func:`~fdtpu_torch.dist.mesh.tp_parts`
cuts them again), :func:`grad_norm_fn` is the clip's global norm over the
parts.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed import ProcessGroup

from fdtpu_torch.dist.mesh import check_model_axis, tp_join, tp_param_spec, tp_parts
from fdtpu_torch.dist.parallel import Axis


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Identity forward; backward, the sum of the ranks' gradients."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """The sum of the ranks' ``x`` forward; identity backward."""
    return _ReduceFromModel.apply(x, group)


def _layers(network: torch.nn.Module):
    from fdtpu_torch.models.transformer import EncoderLayer

    if getattr(network.config, "backbone", "transformer") != "transformer":
        raise ValueError("tensor parallelism takes the transformer backbone, "
                         f"not {network.config.backbone!r}")
    return [m for m in network.modules() if isinstance(m, EncoderLayer)]


def is_sharded(name: str, param: torch.Tensor) -> bool:
    return tp_param_spec(name, param)[0].is_shard()


@torch.no_grad()
def parallelize(network: torch.nn.Module, axis: Axis) -> torch.nn.Module:
    """Give ``network``'s encoder layers this rank's parts of their
    parameters, in place (module docstring); returns ``network``."""
    cfg = network.config
    check_model_axis(axis.size, cfg.n_head, cfg.dim_feedforward)
    for layer in _layers(network):
        named = dict(layer.named_parameters())
        for name, part in tp_parts({n: p.detach() for n, p in named.items()}, axis.size,
                                   axis.index).items():
            owner, _, leaf = name.rpartition(".")
            setattr(layer.get_submodule(owner), leaf,
                    torch.nn.Parameter(part, requires_grad=named[name].requires_grad))
        layer.n_head //= axis.size
        layer.model_axis = axis
    return network


def full_state(state: dict[str, torch.Tensor], axis: Axis) -> dict[str, torch.Tensor]:
    """The full tensors of a state of this rank's parts (a network's
    ``state_dict``, or any ``{parameter name: tensor}``); every rank of the
    axis calls it, and every rank gets the full state."""
    out = {}
    for name, value in state.items():
        placement, blocks = tp_param_spec(name, value)
        if not placement.is_shard():
            out[name] = value
            continue
        parts = [torch.empty_like(value) for _ in range(axis.size)]
        dist.all_gather(parts, value.contiguous(), group=axis.group)
        out[name] = tp_join(parts, placement, blocks)
    return out


def grad_norm_fn(names: list[str], params: list[torch.Tensor],
                 axis: Axis) -> Callable[[list[torch.Tensor]], torch.Tensor]:
    """The global L2 norm of gradients laid out as ``params`` (named
    ``names``): the replicated ones counted once, the parts of the sharded
    ones summed over the axis."""
    sharded = [is_sharded(n, p) for n, p in zip(names, params)]

    def norm(grads: list[torch.Tensor]) -> torch.Tensor:
        own = torch.stack([torch.sum(g.float() ** 2) for g, s in zip(grads, sharded) if s]).sum()
        dist.all_reduce(own, group=axis.group)
        rep = [torch.sum(g.float() ** 2) for g, s in zip(grads, sharded) if not s]
        total = own + (torch.stack(rep).sum() if rep else 0.0)
        return torch.sqrt(total).to(grads[0].dtype)

    return norm
