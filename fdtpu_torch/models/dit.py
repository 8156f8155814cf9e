"""The DiT backbone's parts: adaLN-Zero blocks over the tokens of a series
(Peebles & Xie, "Scalable Diffusion Models with Transformers", ICCV 2023;
``models.py`` of https://github.com/facebookresearch/DiT).

With ``c`` the conditioning (here the time embedding alone):

    shift1, scale1, gate1, shift2, scale2, gate2 = Linear(D, 6D)(SiLU(c))
    x = x + gate1 ⊙ Attn(LN(x)·(1 + scale1) + shift1)
    x = x + gate2 ⊙ MLP(LN(x)·(1 + scale2) + shift2)

``LN`` has no affine and eps ``ln_eps`` (DiT's 1e-6); ``Attn`` is timm's
``Attention`` with a biased qkv projection laid out ``[3][H][Dh]``,
softmax(q·kᵀ/√Dh)·v, then ``proj``; ``MLP`` is fc1 (D → F), GELU with the
tanh approximation, fc2 (F → D).  The time embedding is the sinusoid of 256
features (cos half first, max period 10000) of ``1000·t`` (DiT's step-index
range for the continuous t ∈ [eps, 1]), then Linear(256, D), SiLU,
Linear(D, D).  Positions are the fixed 1-D sin-cos table (sin half first),
computed in float64 as DiT's numpy does.  The final layer modulates a
last LayerNorm with Linear(D, 2D)(SiLU(c)) and projects to the channels.

Attention takes the backbone's resolved ``attention_impl``: ``"einsum"``
(:func:`~fdtpu_torch.kernels.attention.mha_plain`), which ``"auto"``
resolves to past head_dim 32 (DiT's published heads are 64 or 72 wide), or
B1/B2 through ``blockdiag_mha_trainable`` at a narrower head.  Each block's
work sits in three profiler ranges (:func:`~fdtpu_torch.utils.profiling.
profiler_range`, open only while ``torch.profiler`` runs outside a
capture): ``fdtpu.dit.modulation`` (SiLU and Linear(D, 6D), both
LayerNorms, modulate, gate and residual), ``fdtpu.dit.attention`` (``Attn``)
and ``fdtpu.dit.mlp`` (``MLP``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fdtpu_torch.kernels.attention import mha_plain
from fdtpu_torch.kernels.blockdiag_attention import blockdiag_mha_trainable
from fdtpu_torch.models.initializers import xavier_uniform_
from fdtpu_torch.models.transformer import KERNEL_IMPLS, _lin
from fdtpu_torch.utils.profiling import profiler_range

FREQ_FEATURES = 256  # DiT's frequency_embedding_size
MAX_PERIOD = 10000.0
TIME_SCALE = 1000.0  # t ∈ [eps, 1] to DiT's step-index range


def sincos_table(max_len: int, d_model: int) -> torch.Tensor:
    """DiT's ``get_1d_sincos_pos_embed_from_grid`` at positions 0..max_len−1:
    (max_len, d_model) float32, sin half first, in float64 before the cast."""
    omega = 1.0 / MAX_PERIOD ** (np.arange(d_model // 2, dtype=np.float64) / (d_model / 2.0))
    out = np.arange(max_len, dtype=np.float64)[:, None] * omega[None, :]
    return torch.from_numpy(np.concatenate([np.sin(out), np.cos(out)], axis=1)).float()


def timestep_features(t: torch.Tensor) -> torch.Tensor:
    """DiT's ``timestep_embedding`` of ``1000·t``: (B, 256) float32, cos half
    first."""
    half = FREQ_FEATURES // 2
    freqs = torch.exp(-math.log(MAX_PERIOD)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = (t.float() * TIME_SCALE)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _zero_(layer: nn.Linear) -> None:
    with torch.no_grad():
        layer.weight.zero_()
        layer.bias.zero_()


def _xavier_(layer: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """DiT's ``_basic_init``: xavier-uniform weight, zero bias."""
    xavier_uniform_(layer.weight, generator)
    with torch.no_grad():
        layer.bias.zero_()


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale) + shift


class TimestepEmbedder(nn.Module):
    def __init__(self, d_model: int) -> None:
        super().__init__()
        self.linear1 = nn.utils.skip_init(nn.Linear, FREQ_FEATURES, d_model)
        self.linear2 = nn.utils.skip_init(nn.Linear, d_model, d_model)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, 0.02) weights, zero biases."""
        with torch.no_grad():
            for layer in (self.linear1, self.linear2):
                layer.weight.normal_(generator=generator).mul_(0.02)
                layer.bias.zero_()

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _lin(F.silu(_lin(timestep_features(t).to(dtype), self.linear1)), self.linear2)


class DiTBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, dim_feedforward: int, ln_eps: float,
                 attention_impl: str) -> None:
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is not a multiple of n_head {n_head}")
        self.n_head, self.ln_eps, self.attention_impl = n_head, ln_eps, attention_impl
        self.modulation = nn.utils.skip_init(nn.Linear, d_model, 6 * d_model)
        self.qkv = nn.utils.skip_init(nn.Linear, d_model, 3 * d_model)
        self.proj = nn.utils.skip_init(nn.Linear, d_model, d_model)
        self.fc1 = nn.utils.skip_init(nn.Linear, d_model, dim_feedforward)
        self.fc2 = nn.utils.skip_init(nn.Linear, dim_feedforward, d_model)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """DiT's ``initialize_weights``: xavier-uniform Linears with zero
        biases, the adaLN modulation zero (so the block starts as the
        identity)."""
        for layer in (self.qkv, self.proj, self.fc1, self.fc2):
            _xavier_(layer, generator)
        _zero_(self.modulation)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], eps=self.ln_eps)

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.n_head
        qkv = _lin(x, self.qkv)
        if self.attention_impl in KERNEL_IMPLS:
            # B1's layouts: q merged (B, T, D), k (B, H, Dh, T), v (B, H, T, Dh).
            q, k, v = qkv.split(d, dim=-1)
            k = k.reshape(b, t, h, d // h).permute(0, 2, 3, 1).contiguous()
            v = v.reshape(b, t, h, d // h).permute(0, 2, 1, 3).contiguous()
            out = blockdiag_mha_trainable(q.contiguous(), k, v,
                                          shift=self.attention_impl == "blockdiag")
        else:
            q, k, v = (a.reshape(b, t, h, d // h) for a in qkv.split(d, dim=-1))
            out = mha_plain(q, k, v).reshape(b, t, d)
        return _lin(out, self.proj)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """(B, T, D) hidden states under the conditioning ``c`` (B, D)."""
        with profiler_range("fdtpu.dit.modulation"):
            mod = _lin(F.silu(c), self.modulation)[:, None, :]
            shift1, scale1, gate1, shift2, scale2, gate2 = mod.chunk(6, dim=-1)
            h = _modulate(self._norm(x), shift1, scale1)
        with profiler_range("fdtpu.dit.attention"):
            a = self._attention(h)
        with profiler_range("fdtpu.dit.modulation"):
            x = x + gate1 * a
            h = _modulate(self._norm(x), shift2, scale2)
        with profiler_range("fdtpu.dit.mlp"):
            m = _lin(F.gelu(_lin(h, self.fc1), approximate="tanh"), self.fc2)
        with profiler_range("fdtpu.dit.modulation"):
            return x + gate2 * m


class FinalLayer(nn.Module):
    def __init__(self, d_model: int, n_channels: int, ln_eps: float) -> None:
        super().__init__()
        self.ln_eps = ln_eps
        self.modulation = nn.utils.skip_init(nn.Linear, d_model, 2 * d_model)
        self.linear = nn.utils.skip_init(nn.Linear, d_model, n_channels)

    def reset_parameters(self) -> None:
        """DiT's ``initialize_weights``: both zero, so the network starts at 0."""
        _zero_(self.modulation)
        _zero_(self.linear)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = _lin(F.silu(c), self.modulation)[:, None, :].chunk(2, dim=-1)
        return _lin(_modulate(F.layer_norm(x, x.shape[-1:], eps=self.ln_eps), shift, scale),
                    self.linear)
