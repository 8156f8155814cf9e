"""Post-norm transformer encoder layer, full-attention mode (port of
``fdtpu/models/transformer.py:44-129, 176-274``).

Semantics follow torch's ``nn.TransformerEncoderLayer`` defaults: post-norm,
ReLU, dim_feedforward 2048, LayerNorm eps 1e-5 (statistics in float32, cast
back to the compute dtype before scale and bias), dropout 0.1.  Dropout acts
only in ``forward(x, train=True, generator=g)``, at the three sites of the
JAX layer (attention output, FFN hidden, FFN output): a keep-mask drawn from
``g`` and ``x / keep`` where kept, as ``_maybe_dropout``
(``fdtpu/models/transformer.py:109-116``).  Without a generator there is no
dropout, as the JAX layer has none without a key.  The cached (MIXED /
CACHED) modes of the KV-level cache are not ported yet (ROADMAP.md).

``attention_impl``:

* ``"einsum"`` — plain attention over ``(B, T, H, Dh)``, float32 scores and
  softmax, value contraction in the compute dtype.
* ``"blockdiag"`` / ``"blockdiag_noshift"`` — the fused kernels through
  ``blockdiag_mha_trainable`` (:mod:`fdtpu_torch.kernels.blockdiag_attention`:
  forward B1, backward B2); the projections write
  straight into its layouts (q merged, k ``(B, H, Dh, T)``, v
  ``(B, H, T, Dh)``).  ``noshift`` drops the max subtraction; it was measured
  non-finite on full sampling chains and is kept for parity only.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fdtpu_torch.kernels.blockdiag_attention import blockdiag_mha_trainable
from fdtpu_torch.models.initializers import linear_init_, xavier_uniform_

ATTENTION_IMPLS = ("einsum", "blockdiag", "blockdiag_noshift")


class LayerNorm(nn.Module):
    """LayerNorm with float32 statistics; the normalized value is cast back
    to the input dtype before the (compute-dtype) scale and bias."""

    def __init__(self, d_model: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d_model))
        self.bias = nn.Parameter(torch.zeros(d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        normed = (x32 - mean) * torch.rsqrt(var + self.eps)
        return normed.to(x.dtype) * self.weight.to(x.dtype) + self.bias.to(x.dtype)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention over (B, T, H, Dh): float32 scores and
    softmax, value contraction in v's dtype."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dh)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _lin(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _dropout(
    x: torch.Tensor, rate: float, train: bool, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout with a keep-mask drawn from ``generator``; the
    identity unless training with a positive rate and a generator."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


class EncoderLayer(nn.Module):
    def __init__(
        self,
        d_model: int,
        n_head: int,
        dim_feedforward: int = 2048,
        ln_eps: float = 1e-5,
        attention_impl: str = "einsum",
        dropout: float = 0.1,
    ) -> None:
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, got {attention_impl!r}")
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is not a multiple of n_head {n_head}")
        self.n_head = n_head
        self.attention_impl = attention_impl
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.utils.skip_init(nn.Linear, d_model, d_model)
        self.linear1 = nn.utils.skip_init(nn.Linear, d_model, dim_feedforward)
        self.linear2 = nn.utils.skip_init(nn.Linear, dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, ln_eps)
        self.norm2 = LayerNorm(d_model, ln_eps)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch MultiheadAttention: xavier-uniform in-projection and zero
        in/out biases; Linear defaults elsewhere; LayerNorm ones/zeros."""
        xavier_uniform_(self.in_proj_weight, generator)
        linear_init_(self.out_proj, generator)
        linear_init_(self.linear1, generator)
        linear_init_(self.linear2, generator)
        with torch.no_grad():
            self.in_proj_bias.zero_()
            self.out_proj.bias.zero_()
            for norm in (self.norm1, self.norm2):
                norm.weight.fill_(1.0)
                norm.bias.zero_()

    def _self_attention(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.n_head
        dh = d // h
        w = self.in_proj_weight.to(x.dtype)
        bias = self.in_proj_bias.to(x.dtype)
        if self.attention_impl == "einsum":
            qkv = F.linear(x, w, bias)
            q, k, v = (a.reshape(b, t, h, dh) for a in qkv.split(d, dim=-1))
            return _attention(q, k, v).reshape(b, t, d)
        # Kernel layouts: q merged (B, T, D), k (B, H, Dh, T), v (B, H, T, Dh).
        q = F.linear(x, w[:d], bias[:d])
        k = torch.einsum("btc,hec->bhet", x, w[d:2 * d].reshape(h, dh, d))
        k = (k + bias[d:2 * d].reshape(1, h, dh, 1)).contiguous()
        v = torch.einsum("btc,hec->bhte", x, w[2 * d:].reshape(h, dh, d))
        v = (v + bias[2 * d:].reshape(1, h, 1, dh)).contiguous()
        return blockdiag_mha_trainable(q, k, v, shift=self.attention_impl == "blockdiag")

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """One post-norm encoder layer over (B, T, D) hidden states; dropout
        only with ``train`` and a ``generator``."""
        rate = self.dropout
        attn = _lin(self._self_attention(x), self.out_proj)
        x = self.norm1(x + _dropout(attn, rate, train, generator))
        ff = _dropout(torch.relu(_lin(x, self.linear1)), rate, train, generator)
        ff = _lin(ff, self.linear2)
        return self.norm2(x + _dropout(ff, rate, train, generator))
