"""Parameter initializers (port of ``fdtpu/models/initializers.py:19-45``).

torch-default distributions drawn from an explicit ``torch.Generator``:
nn.Linear U(±1/√fan_in) for weight and bias, nn.Embedding N(0, 1),
nn.MultiheadAttention xavier-uniform in-projection.  Weights are laid out the
torch way, ``(out, in)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


@torch.no_grad()
def linear_init_(linear: nn.Linear, generator: Optional[torch.Generator] = None) -> None:
    """nn.Linear default: W, b ~ U(±1/√fan_in)."""
    bound = 1.0 / math.sqrt(linear.in_features)
    linear.weight.uniform_(-bound, bound, generator=generator)
    if linear.bias is not None:
        linear.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def embedding_init_(table: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
    """nn.Embedding default: N(0, 1)."""
    table.normal_(generator=generator)


@torch.no_grad()
def xavier_uniform_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
    """U(±√(6/(fan_in+fan_out))) for an ``(out, in)`` weight."""
    fan_out, fan_in = weight.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    weight.uniform_(-bound, bound, generator=generator)


def max_norm_rows(table: torch.Tensor, max_norm: float, eps: float = 1e-7) -> torch.Tensor:
    """Row-wise norm clipping, the functional analog of torch Embedding
    ``max_norm``.  Unlike ``nn.Embedding(max_norm=...)`` it never rewrites
    the stored table: the clipped rows exist only in the returned tensor."""
    norms = torch.linalg.vector_norm(table, dim=-1, keepdim=True)
    scale = torch.clamp(max_norm / (norms + eps), max=1.0)
    return table * scale
