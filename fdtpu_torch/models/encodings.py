"""Positional and diffusion-time encodings (port of
``fdtpu/models/encodings.py:31-95``).

* :class:`PositionalEncoding`: learnable table whose rows are clipped to norm
  √d at lookup (functionally, the stored table is never rewritten).
* :class:`GaussianFourierProjection`: frozen ``W ~ N(0,1)·scale`` kept as a
  buffer (never trained), sin/cos features of the phase 2π·t·W, then a
  learnable dense projection.  The phase is always formed in float32: it
  reaches |2π·t·W| ≈ 200, where a bf16 phase would corrupt the time
  conditioning.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fdtpu_torch.models.initializers import embedding_init_, linear_init_, max_norm_rows


class PositionalEncoding(nn.Module):
    def __init__(self, d_model: int, max_len: int) -> None:
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(max_len, d_model))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        embedding_init_(self.embedding, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, L, D) → x + PE[:L] with row norms clipped at √d."""
        table = max_norm_rows(self.embedding.to(x.dtype), math.sqrt(x.shape[-1]))
        return x + table[None, : x.shape[1], :]


class GaussianFourierProjection(nn.Module):
    def __init__(self, d_model: int, scale: float = 30.0) -> None:
        super().__init__()
        self.scale = scale
        self.register_buffer("W", torch.empty((d_model + 1) // 2))
        self.dense = torch.nn.utils.skip_init(nn.Linear, d_model, d_model)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.W.normal_(generator=generator).mul_(self.scale)
        linear_init_(self.dense, generator)

    def forward(
        self, x: torch.Tensor, timesteps: torch.Tensor, use_time_axis: bool = True
    ) -> torch.Tensor:
        """x + Dense(concat(sin, cos)(2π·t·W))[:d_model]."""
        d_model = self.dense.in_features
        time_proj = (
            timesteps.float()[:, None] * self.W.to(x.dtype).float()[None, :] * 2.0 * math.pi
        )
        emb = torch.cat([torch.sin(time_proj), torch.cos(time_proj)], dim=-1)
        w = self.dense.weight.to(x.dtype)
        projected = F.linear(emb[:, :d_model].to(x.dtype), w, self.dense.bias.to(x.dtype))
        if use_time_axis:
            projected = projected[:, None, :]
        return x + projected
