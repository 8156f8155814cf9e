"""Transformer score network (port of
``fdtpu/models/score_models.py:50-273, 345-397``).

Pipeline: Linear(C→D) embed → learnable positional encoding (max-norm √d) →
Gaussian-Fourier time encoding → post-norm encoder stack → Linear(D→C)
unembed.  Config defaults follow the flagship (d_model 72, 10 layers, 12
heads, ≈3.2M parameters).

The JAX package's ``variables`` pytree becomes the :class:`ScoreNetwork`
module; ``init_score_model`` builds it from an explicit ``torch.Generator``
on the requested device (CUDA unless ``device="cpu"``), frozen for
sampling.  ``forward(x, t, train=True, generator=g)`` is the training
forward, with dropout drawn from ``g`` (the trainer,
:mod:`fdtpu_torch.train.trainer`, makes its own trainable copy).  The cached
forwards and the MLP/LSTM backbones are still to port (ROADMAP.md).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fdtpu_torch.models.encodings import GaussianFourierProjection, PositionalEncoding
from fdtpu_torch.models.initializers import linear_init_
from fdtpu_torch.models.transformer import EncoderLayer
from fdtpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ScoreModelConfig:
    """Static architecture config; same fields and defaults as the JAX one."""

    n_channels: int
    max_len: int
    d_model: int = 72
    num_layers: int = 10
    n_head: int = 12
    dim_feedforward: int = 2048
    dropout: float = 0.1
    ln_eps: float = 1e-5
    backbone: str = "transformer"  # "transformer" | "mlp" | "lstm"
    d_mlp: int = 1024
    gfp_scale: float = 30.0
    # "einsum" | "blockdiag" (the fused Hopper kernel) | "blockdiag_noshift"
    # | "auto" (see resolve_attention_impl).
    attention_impl: str = "einsum"
    # Run the network in this dtype ("float32" | "bfloat16"); the score
    # output always has the input's dtype.
    compute_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def _cdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def resolve_attention_impl(impl: str, head_dim: int = 0, device_type: str = "cuda") -> str:
    """Resolve ``"auto"``: the fused kernel on CUDA when heads are tiny
    (head_dim < 16), einsum otherwise and always on the CPU.

    The head_dim < 16 crossover was measured on a TPU for the TPU kernel; on
    the H100 it is still to be settled by measurement (ROADMAP.md)."""
    if impl == "auto":
        if device_type != "cuda" or head_dim >= 16:
            return "einsum"
        return "blockdiag"
    return impl


class ScoreNetwork(nn.Module):
    """The transformer score network; ``forward(x, t)`` is ``score_apply``."""

    def __init__(self, config: ScoreModelConfig, attention_impl: str) -> None:
        super().__init__()
        cfg = config
        self.config = cfg
        self.embedder = nn.utils.skip_init(nn.Linear, cfg.n_channels, cfg.d_model)
        self.pos_encoder = PositionalEncoding(cfg.d_model, cfg.max_len)
        self.time_encoder = GaussianFourierProjection(cfg.d_model, cfg.gfp_scale)
        self.backbone = nn.ModuleList(
            EncoderLayer(cfg.d_model, cfg.n_head, cfg.dim_feedforward, cfg.ln_eps,
                         attention_impl, cfg.dropout)
            for _ in range(cfg.num_layers)
        )
        self.unembedder = nn.utils.skip_init(nn.Linear, cfg.d_model, cfg.n_channels)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        linear_init_(self.embedder, generator)
        linear_init_(self.unembedder, generator)
        self.pos_encoder.reset_parameters(generator)
        self.time_encoder.reset_parameters(generator)
        for layer in self.backbone:
            layer.reset_parameters(generator)

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Uncached score forward: ``(B, max_len, n_channels) → same shape``;
        dropout only with ``train`` and a ``generator``."""
        cfg = self.config
        if tuple(x.shape[1:]) != (cfg.max_len, cfg.n_channels):
            raise ValueError(
                f"X has wrong shape, expected (*, {cfg.max_len}, {cfg.n_channels}), "
                f"got {tuple(x.shape)}"
            )
        out_dtype = x.dtype
        x = x.to(cfg._cdtype)
        timesteps = timesteps.to(cfg._cdtype)
        h = F.linear(x, self.embedder.weight.to(x.dtype), self.embedder.bias.to(x.dtype))
        h = self.pos_encoder(h)
        h = self.time_encoder(h, timesteps)
        for layer in self.backbone:
            h = layer(h, train, generator)
        out = F.linear(h, self.unembedder.weight.to(h.dtype), self.unembedder.bias.to(h.dtype))
        return out.to(out_dtype)

    def compute_copy(self) -> "ScoreNetwork":
        """The network with every parameter and buffer in the compute dtype —
        cast once before a sampling chain rather than in every step."""
        if self.config._cdtype == torch.float32:
            return self
        return copy.deepcopy(self).to(self.config._cdtype)


def init_score_model(
    cfg: ScoreModelConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> ScoreNetwork:
    """Initialize a transformer score network with torch-default
    distributions drawn from ``generator`` (on the CPU, so a seed gives the
    same weights on every device), then move it to ``device``."""
    if cfg.backbone != "transformer":
        raise NotImplementedError(
            f"backbone={cfg.backbone!r}: the MLP/LSTM backbones are not ported "
            "yet (ROADMAP.md, MLP and LSTM backbones)"
        )
    dev = resolve_device(device)
    impl = resolve_attention_impl(cfg.attention_impl, cfg.head_dim, dev.type)
    net = ScoreNetwork(cfg, impl)
    net.reset_parameters(generator)
    return net.to(dev).eval().requires_grad_(False)


def score_apply(
    network: ScoreNetwork,
    x: torch.Tensor,
    timesteps: torch.Tensor,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Uncached score forward: ``(B, max_len, n_channels)``."""
    return network(x, timesteps, train, generator)


def param_count(network: nn.Module) -> int:
    return sum(p.numel() for p in network.parameters())


@dataclasses.dataclass
class ScoreModel:
    """Bundle of (config, network, scheduler), the analog of the JAX
    ``ScoreModel`` dataclass."""

    config: ScoreModelConfig
    network: ScoreNetwork
    scheduler: Any  # fdtpu_torch.diffusion.sde.SDE
    num_training_steps: int = 1000
    lr_max: float = 1e-3
    likelihood_weighting: bool = False

    @property
    def n_channels(self) -> int:
        return self.config.n_channels

    @property
    def max_len(self) -> int:
        return self.config.max_len

    def __call__(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        return score_apply(self.network, x, timesteps)

    def param_count(self) -> int:
        return param_count(self.network)
