"""Transformer score network (port of
``fdtpu/models/score_models.py:50-273, 345-535``).

Pipeline: Linear(C→D) embed → learnable positional encoding (max-norm √d) →
Gaussian-Fourier time encoding → post-norm encoder stack → Linear(D→C)
unembed.  Config defaults follow the flagship (d_model 72, 10 layers, 12
heads, ≈3.2M parameters).

The JAX package's ``variables`` pytree becomes the :class:`ScoreNetwork`
module; ``init_score_model`` builds it from an explicit ``torch.Generator``
on the requested device (CUDA unless ``device="cpu"``), frozen for
sampling.  ``forward(x, t, train=True, generator=g)`` is the training
forward, with dropout drawn from ``g`` (the trainer,
:mod:`fdtpu_torch.train.trainer`, makes its own trainable copy).

The E²-CRF cache's forwards, :func:`score_apply_cached` (KV level, and the
token level's full refreshes) and :func:`score_apply_topk` (token level),
take the K/V store ``(k, v)``, each ``(num_layers, B, T, H, Dh)`` in the
compute dtype, and update it in place; the JAX package's ``lax.switch`` over
the mode becomes a branch on a host int.  The MLP/LSTM backbones are still to
port (ROADMAP.md).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fdtpu_torch.models.encodings import GaussianFourierProjection, PositionalEncoding
from fdtpu_torch.models.initializers import linear_init_, max_norm_rows
from fdtpu_torch.models.transformer import EncoderLayer, KVStore
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

    def _check_input(self, x: torch.Tensor) -> None:
        cfg = self.config
        if tuple(x.shape[1:]) != (cfg.max_len, cfg.n_channels):
            raise ValueError(
                f"X has wrong shape, expected (*, {cfg.max_len}, {cfg.n_channels}), "
                f"got {tuple(x.shape)}"
            )

    def _unembed(self, h: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        w, b = self.unembedder.weight.to(h.dtype), self.unembedder.bias.to(h.dtype)
        return F.linear(h, w, b).to(out_dtype)

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Uncached score forward: ``(B, max_len, n_channels) → same shape``;
        dropout only with ``train`` and a ``generator``."""
        self._check_input(x)
        out_dtype = x.dtype
        h = self._embed(x.to(self.config._cdtype), timesteps)
        for layer in self.backbone:
            h = layer(h, train, generator)
        return self._unembed(h, out_dtype)

    def _embed(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        h = F.linear(x, self.embedder.weight.to(x.dtype), self.embedder.bias.to(x.dtype))
        h = self.pos_encoder(h)
        return self.time_encoder(h, timesteps.to(x.dtype))

    def _check_store(self, kv_cache: KVStore) -> None:
        cfg = self.config
        want = (cfg.num_layers, cfg.max_len, cfg.n_head, cfg.head_dim)
        for a in kv_cache:
            if (a.shape[0], *a.shape[2:]) != want or a.dtype != cfg._cdtype:
                raise ValueError(
                    f"K/V store {tuple(a.shape)} {a.dtype}: need (L, B, T, H, Dh) = "
                    f"({want[0]}, B, {', '.join(map(str, want[1:]))}) in {cfg._cdtype}"
                )

    def forward_cached(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        kv_cache: KVStore,
        recompute_mask: Optional[torch.Tensor],
        mode: int,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Cached score forward in ``mode``; the store is updated in place.
        Returns ``(score, crf)`` with crf ``(num_layers, T, d_model)``, the
        hidden state of batch element 0 after each layer."""
        self._check_input(x)
        self._check_store(kv_cache)
        out_dtype = x.dtype
        h = self._embed(x.to(self.config._cdtype), timesteps)
        crf = []
        for layer, k, v in zip(self.backbone, *kv_cache):
            h = layer.forward_cached(h, (k, v), mode, recompute_mask)
            crf.append(h[0])
        return self._unembed(h, out_dtype), torch.stack(crf)

    def forward_topk(
        self, x: torch.Tensor, timesteps: torch.Tensor, kv_cache: KVStore, idx: torch.Tensor
    ) -> torch.Tensor:
        """Token-budget score forward: only the ``idx`` rows, end to end; the
        store is updated in place.  Returns the rows' score (B, k, C)."""
        cfg = self.config
        self._check_input(x)
        self._check_store(kv_cache)
        out_dtype = x.dtype
        x_rows = x.to(cfg._cdtype).index_select(1, idx)
        h = F.linear(x_rows, self.embedder.weight.to(x_rows.dtype),
                     self.embedder.bias.to(x_rows.dtype))
        # Positional rows: the same max-norm-√d lookup as the full path.
        table = max_norm_rows(self.pos_encoder.embedding.to(h.dtype), math.sqrt(cfg.d_model))
        h = self.time_encoder(h + table.index_select(0, idx)[None], timesteps.to(h.dtype))
        for layer, k, v in zip(self.backbone, *kv_cache):
            h = layer.forward_topk(h, (k, v), idx)
        return self._unembed(h, out_dtype)

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


def score_apply_cached(
    network: ScoreNetwork,
    x: torch.Tensor,
    timesteps: torch.Tensor,
    kv_cache: KVStore,
    recompute_mask: Optional[torch.Tensor],
    mode: int,
) -> tuple[torch.Tensor, KVStore, torch.Tensor]:
    """Cached transformer score forward (``fdtpu/models/score_models.py:470``).

    ``kv_cache`` is ``(k, v)``, each ``(num_layers, B, T, H, Dh)`` in the
    compute dtype, updated in place and returned; ``recompute_mask`` (T,)
    bool is read in MODE_MIXED; ``mode`` is MODE_FULL, MODE_MIXED or
    MODE_CACHED.  MODE_FULL keeps the network's ``attention_impl`` (B1 under
    ``"blockdiag"``); MIXED and CACHED attend through B4 under a kernel
    implementation.  Returns ``(score, kv_cache, crf)``."""
    score, crf = network.forward_cached(x, timesteps, kv_cache, recompute_mask, mode)
    return score, kv_cache, crf


def score_apply_topk(
    network: ScoreNetwork,
    x: torch.Tensor,
    timesteps: torch.Tensor,
    kv_cache: KVStore,
    idx: torch.Tensor,
) -> tuple[torch.Tensor, KVStore]:
    """Token-budget score forward (``fdtpu/models/score_models.py:400``):
    recompute only the ``idx`` (k,) token rows, shared across the batch,
    scattering their fresh K/V into ``kv_cache`` in place.  Returns
    ``(out_rows, kv_cache)`` with out_rows ``(B, k, C)``."""
    return network.forward_topk(x, timesteps, kv_cache, idx), kv_cache


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
