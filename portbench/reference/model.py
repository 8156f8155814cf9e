"""Plain PyTorch reference of the FourierDiffusion transformer score network
and of its VP SDE, in float32, with no kernel, cache or batching of the
port's (FourierDiffusion's ``score_models.py``, ``schedulers/sde.py``,
``losses.py``; the JAX package's description of them).

The network: Linear(C→D) embedding; a learnable positional table whose rows
are clipped to norm √D at lookup; the Gaussian-Fourier time encoding
(sin, cos of 2π·t·W, the first D features, a dense layer); post-norm
encoder layers as torch's ``nn.TransformerEncoderLayer`` (ReLU, LayerNorm
eps 1e-5, dropout at the attention output, the FFN's hidden layer and its
output); Linear(D→C) unembedding.  Dropout draws a keep-mask
``rand(shape) < 1 − p`` from the step's generator at those three sites, in
that order, layer after layer, after the loss's draws of t and z (the
draw order that FourierDiffusion's JAX port documents: t, z, then the
masks).  Attention is softmax(q·kᵀ/√Dh)·v per head, materialised.

``tf32=True`` runs the matrix products in TF32: the lower precision that
serves as the control of the comparison."""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in float32 (TF32 off) or, for the control, TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _layer_norm(x, w, b, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _dropout(x, rate, generator):
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def score(weights: dict, model: dict, x: torch.Tensor, t: torch.Tensor,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The network's score ``(B, T, C)`` at times ``t`` ``(B,)``; dropout
    only with a ``generator``."""
    w = weights
    d, h_n = model["d_model"], model["n_head"]
    dh = d // h_n
    rate = model["dropout"]
    b, t_len, _ = x.shape
    h = x @ w["embedder.weight"].T + w["embedder.bias"]
    table = w["pos_encoder.embedding"]
    norms = torch.sqrt((table * table).sum(dim=-1, keepdim=True))
    table = table * torch.clamp(math.sqrt(d) / (norms + 1e-7), max=1.0)
    h = h + table[None, :t_len]
    # Left to right, as FourierDiffusion writes it: x[:, None] * W[None, :] * 2 * pi.
    phase = t[:, None] * w["time_encoder.W"][None, :] * 2.0 * math.pi
    emb = torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1)[:, :d]
    h = h + (emb @ w["time_encoder.dense.weight"].T + w["time_encoder.dense.bias"])[:, None, :]
    for i in range(model["num_layers"]):
        p = f"backbone.{i}."
        qkv = h @ w[p + "in_proj_weight"].T + w[p + "in_proj_bias"]
        q, k, v = (a.reshape(b, t_len, h_n, dh) for a in qkv.split(d, dim=-1))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, t_len, d)
        o = o @ w[p + "out_proj.weight"].T + w[p + "out_proj.bias"]
        h = _layer_norm(h + _dropout(o, rate, generator), w[p + "norm1.weight"],
                        w[p + "norm1.bias"], model["ln_eps"])
        ff = torch.relu(h @ w[p + "linear1.weight"].T + w[p + "linear1.bias"])
        ff = _dropout(ff, rate, generator)
        ff = ff @ w[p + "linear2.weight"].T + w[p + "linear2.bias"]
        h = _layer_norm(h + _dropout(ff, rate, generator), w[p + "norm2.weight"],
                        w[p + "norm2.bias"], model["ln_eps"])
    return h @ w["unembedder.weight"].T + w["unembedder.bias"]


class VP:
    """The VP SDE with the diagonal Fourier noise scaling G (1/√2 but at the
    DC and, for an even length, the Nyquist row)."""

    def __init__(self, sde: dict, max_len: int, device) -> None:
        self.beta_min, self.beta_max, self.eps = sde["beta_min"], sde["beta_max"], sde["eps"]
        g = torch.ones((max_len,), dtype=torch.float32)
        if sde["fourier_noise_scaling"]:
            g.fill_(1.0 / math.sqrt(2.0))
            g[0] = 1.0
            if max_len % 2 == 0:
                g[max_len // 2] = 1.0
        self.g = g.to(device)

    def timesteps(self, n: int, device):
        """``linspace(1, eps, n)`` formed as ``1·(1−s) + eps·s`` in float32
        (jnp.linspace's float32 arithmetic), and the step ts[0] − ts[1]."""
        one, eps = np.float32(1.0), np.float32(self.eps)
        s = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
        grid = np.concatenate([one * (one - s) + eps * s, [eps]]).astype(np.float32)
        ts = torch.from_numpy(grid).to(device)
        return ts, ts[0] - ts[1]

    def _log_mean(self, t):
        return -0.25 * t**2 * (self.beta_max - self.beta_min) - 0.5 * t * self.beta_min

    def mean_std(self, x, t):
        """The perturbation kernel's mean ``(B, T, C)`` and std ``(B, T)``."""
        lm = self._log_mean(t)
        mean = torch.exp(lm)[:, None, None] * x
        std = torch.sqrt(1.0 - torch.exp(2.0 * lm))[:, None] * self.g[None, :]
        return mean, std

    def prior(self, z):
        return self.g[None, :, None] * z

    def step(self, score, t, x, z, dt):
        """One reverse Euler–Maruyama step."""
        beta = self.beta_min + t * (self.beta_max - self.beta_min)
        diffusion = torch.sqrt(beta) * self.g
        drift = -0.5 * beta * x - (diffusion**2)[None, :, None] * score
        return x - drift * dt + torch.sqrt(dt) * diffusion[None, :, None] * z
