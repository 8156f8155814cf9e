"""Plain PyTorch reference of the DiT score network (Peebles & Xie, "Scalable
Diffusion Models with Transformers", ICCV 2023; ``models.py`` of
https://github.com/facebookresearch/DiT, ``DiT_XL_2``: depth 28, hidden
1152, 16 heads, ``mlp_ratio`` 4) on series tokens, in float32, with no
kernel, cache or batching of the program's.

With ``c`` the conditioning::

    shift1, scale1, gate1, shift2, scale2, gate2 = Linear(D, 6D)(SiLU(c)).chunk(6)
    x = x + gate1 * Attn(LN(x) * (1 + scale1) + shift1)
    x = x + gate2 * MLP(LN(x) * (1 + scale2) + shift2)

``LN`` has no affine, eps ``ln_eps`` (1e-6); ``Attn`` is timm's
``Attention`` with a biased qkv laid out [3][H][Dh], softmax(q·kᵀ/√Dh)·v
materialised, then ``proj``; ``MLP`` is fc1 (D → 4D), GELU with the tanh
approximation, fc2.  ``c`` is the time embedding: the sinusoid of 256
features (cos half first, max period 10000), Linear(256, D), SiLU,
Linear(D, D).  The final layer: shift, scale = Linear(D, 2D)(SiLU(c)),
then Linear(D, C)(LN(x) * (1 + scale) + shift).  Positions: the fixed 1-D
sin-cos table (``get_1d_sincos_pos_embed_from_grid``, sin half first).

Departures from the published model:

1. Patch size 1 over series tokens: the embedder is Linear(C → D) per
   frequency bin, which is what ``PatchEmbed``'s convolution is at kernel 1.
2. Unconditional: no ``LabelEmbedder``; ``c`` is the time embedding alone.
3. ``learn_sigma`` False: the output has C channels.
4. The continuous t ∈ [eps, 1] is fed to the sinusoid as 1000·t, DiT's
   step-index range.
5. Weights follow DiT's ``initialize_weights`` (xavier-uniform Linears,
   zero biases, N(0, 0.02) time MLP), but ``adaLN_modulation`` and
   ``FinalLayer.linear`` are drawn xavier-uniform instead of zero: with zero
   init the output is identically 0.
6. Float32 with TF32 off (``precision(False)``); DiT trained with TF32 on.

``weights`` holds the program's ``state_dict`` names (``embedder``,
``time_embedder.linear1``/``linear2``, ``backbone.<i>.modulation``,
``.qkv``, ``.proj``, ``.fc1``, ``.fc2``, ``final_layer.modulation`` and
``.linear``); run it under ``precision(tf32)`` of ``reference/model.py``."""

from __future__ import annotations

import math

import numpy as np
import torch


def sincos_positions(max_len: int, d_model: int, device) -> torch.Tensor:
    """``get_1d_sincos_pos_embed_from_grid(d_model, arange(max_len))`` in
    float64, as float32."""
    omega = np.arange(d_model // 2, dtype=np.float64)
    omega /= d_model / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", np.arange(max_len, dtype=np.float64), omega)
    table = np.concatenate([np.sin(out), np.cos(out)], axis=1)
    return torch.from_numpy(table).float().to(device)


def timestep_embedding(t: torch.Tensor, dim: int = 256, max_period: float = 10000.0):
    """DiT's ``TimestepEmbedder.timestep_embedding`` of ``1000·t``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(start=0, end=half, dtype=torch.float32) / half)
    args = (1000.0 * t.float())[:, None] * freqs.to(t.device)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _linear(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ w[f"{name}.weight"].T + w[f"{name}.bias"]


def _silu(x):
    return x * torch.sigmoid(x)


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _layer_norm(x, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def score(weights: dict, model: dict, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The network's output ``(B, T, C)`` at times ``t`` ``(B,)``."""
    w = weights
    d, h_n, eps = model["d_model"], model["n_head"], model["ln_eps"]
    dh = d // h_n
    b, t_len, _ = x.shape
    h = _linear(w, "embedder", x) + sincos_positions(t_len, d, x.device)[None]
    c = _linear(w, "time_embedder.linear2",
                _silu(_linear(w, "time_embedder.linear1", timestep_embedding(t))))
    for i in range(model["num_layers"]):
        p = f"backbone.{i}."
        shift1, scale1, gate1, shift2, scale2, gate2 = _linear(
            w, p + "modulation", _silu(c)).chunk(6, dim=1)
        a = _modulate(_layer_norm(h, eps), shift1, scale1)
        qkv = _linear(w, p + "qkv", a).reshape(b, t_len, 3, h_n, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, T, Dh)
        attn = torch.softmax((q * dh ** -0.5) @ k.transpose(-2, -1), dim=-1)
        a = (attn @ v).transpose(1, 2).reshape(b, t_len, d)
        h = h + gate1[:, None, :] * _linear(w, p + "proj", a)
        m = _modulate(_layer_norm(h, eps), shift2, scale2)
        m = _linear(w, p + "fc2", _gelu_tanh(_linear(w, p + "fc1", m)))
        h = h + gate2[:, None, :] * m
    shift, scale = _linear(w, "final_layer.modulation", _silu(c)).chunk(2, dim=1)
    return _linear(w, "final_layer.linear", _modulate(_layer_norm(h, eps), shift, scale))
