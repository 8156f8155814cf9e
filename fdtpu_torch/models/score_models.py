"""Score networks: the transformer, MLP and LSTM backbones (port of
``fdtpu/models/score_models.py``).

Transformer pipeline: Linear(C→D) embed → learnable positional encoding
(max-norm √d) → Gaussian-Fourier time encoding → post-norm encoder stack →
Linear(D→C) unembed.  Config defaults follow the flagship (d_model 72, 10
layers, 12 heads, ≈3.2M parameters).  The MLP backbone
(:class:`MLPScoreNetwork`) embeds the flattened series, adds the time
encoding and runs residual Linear→ReLU→Dropout→Linear→Dropout blocks; the
LSTM backbone (:class:`LSTMScoreNetwork`) runs residual one-directional LSTM
layers over the tokens with no positional encoding and no dropout, as the
JAX package's.

The JAX package's ``variables`` pytree becomes the network module;
``init_score_model`` builds it from an explicit ``torch.Generator`` on the
requested device (CUDA unless ``device="cpu"``), frozen for sampling.
``forward(x, t, train=True, generator=g)`` is the training forward, with
dropout drawn from ``g`` (the trainer, :mod:`fdtpu_torch.train.trainer`,
makes its own trainable copy).

The E²-CRF cache's forwards, :func:`score_apply_cached` (KV level, and the
token level's full refreshes) and :func:`score_apply_topk` (token level),
take the K/V store ``(k, v)``, each ``(num_layers, B, T, H, Dh)`` in the
compute dtype, and update it in place; the JAX package's ``lax.switch`` over
the mode becomes a branch on a host int.  They apply to the transformer only,
as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fdtpu_torch.kernels.blockdiag_attention import MAX_HEAD_DIM
from fdtpu_torch.models.encodings import GaussianFourierProjection, PositionalEncoding
from fdtpu_torch.models.initializers import linear_init_, max_norm_rows
from fdtpu_torch.models.transformer import EncoderLayer, KVStore, _dropout
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
    """Resolve ``"auto"``: the hand-written kernels on CUDA for every head_dim
    they take (up to ``MAX_HEAD_DIM``, 32), einsum past that and always on
    the CPU.

    Measured on the H100 (``chip_smoke.py`` ``head_dim_sweep``, PERF.md §6):
    B1 against the plain attention at B 128, T 187, 12 heads, float32, is
    0.054 against 0.58 ms at head_dim 4 and 0.46 against 0.77 at 32; B2
    against the plain backward 0.13 against 0.95 and 0.97 against 1.15.  The
    JAX package's head_dim < 16 crossover is a TPU measurement."""
    if impl == "auto":
        if device_type != "cuda" or head_dim > MAX_HEAD_DIM:
            return "einsum"
        return "blockdiag"
    return impl


class _Network(nn.Module):
    """What the three backbones share: the input check, the unembedding and
    the compute-dtype copy."""

    config: ScoreModelConfig

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

    def compute_copy(self) -> "_Network":
        """The network with every parameter and buffer in the compute dtype —
        cast once before a sampling chain rather than in every step."""
        if self.config._cdtype == torch.float32:
            return self
        return copy.deepcopy(self).to(self.config._cdtype)


class ScoreNetwork(_Network):
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


class MLPBlock(nn.Module):
    def __init__(self, d_model: int, d_mlp: int) -> None:
        super().__init__()
        self.linear1 = nn.utils.skip_init(nn.Linear, d_model, d_mlp)
        self.linear2 = nn.utils.skip_init(nn.Linear, d_mlp, d_model)


class MLPScoreNetwork(_Network):
    """The MLP backbone (``fdtpu/models/score_models.py:276-309``): the
    flattened (T·C) series embedded to d_model, the time encoding added, then
    residual blocks ``h + Drop(Linear(Drop(ReLU(Linear(h)))))`` (two dropout
    masks a block, drawn in that order), unembedded back to (T, C)."""

    def __init__(self, config: ScoreModelConfig) -> None:
        super().__init__()
        cfg = self.config = config
        flat = cfg.max_len * cfg.n_channels
        self.embedder = nn.utils.skip_init(nn.Linear, flat, cfg.d_model)
        self.time_encoder = GaussianFourierProjection(cfg.d_model, cfg.gfp_scale)
        self.backbone = nn.ModuleList(MLPBlock(cfg.d_model, cfg.d_mlp)
                                      for _ in range(cfg.num_layers))
        self.unembedder = nn.utils.skip_init(nn.Linear, cfg.d_model, flat)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        linear_init_(self.embedder, generator)
        linear_init_(self.unembedder, generator)
        self.time_encoder.reset_parameters(generator)
        for block in self.backbone:
            linear_init_(block.linear1, generator)
            linear_init_(block.linear2, generator)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        self._check_input(x)
        cfg = self.config
        b = x.shape[0]
        h = x.to(cfg._cdtype).reshape(b, cfg.max_len * cfg.n_channels)
        h = F.linear(h, self.embedder.weight.to(h.dtype), self.embedder.bias.to(h.dtype))
        h = self.time_encoder(h, timesteps.to(h.dtype), use_time_axis=False)
        for block in self.backbone:
            y = torch.relu(F.linear(h, block.linear1.weight.to(h.dtype),
                                    block.linear1.bias.to(h.dtype)))
            y = _dropout(y, cfg.dropout, train, generator)
            y = F.linear(y, block.linear2.weight.to(h.dtype), block.linear2.bias.to(h.dtype))
            h = h + _dropout(y, cfg.dropout, train, generator)
        return self._unembed(h, x.dtype).reshape(b, cfg.max_len, cfg.n_channels)


class LSTMLayer(nn.Module):
    """One one-directional LSTM layer over (B, T, D), torch's gate order
    (i, f, g, o) and weight layout ``(4D, D)``, as an explicit loop over the
    tokens (``_lstm_layer``, ``fdtpu/models/score_models.py:312-333``): the
    input projection of every token in one product, then per token the
    recurrent product and the gates."""

    def __init__(self, d_model: int) -> None:
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(4 * d_model, d_model))
        self.w_hh = nn.Parameter(torch.empty(4 * d_model, d_model))
        self.b_ih = nn.Parameter(torch.empty(4 * d_model))
        self.b_hh = nn.Parameter(torch.empty(4 * d_model))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch's LSTM default: every weight and bias U(±1/√D)."""
        bound = 1.0 / math.sqrt(self.w_hh.shape[1])
        for p in (self.w_ih, self.w_hh, self.b_ih, self.b_hh):
            p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        pre = F.linear(x, self.w_ih.to(x.dtype), self.b_ih.to(x.dtype))
        w_hh_t, b_hh = self.w_hh.to(x.dtype).t(), self.b_hh.to(x.dtype)
        h = x.new_zeros((b, d))
        c = x.new_zeros((b, d))
        out = []
        for s in range(t):
            gates = pre[:, s] + torch.addmm(b_hh, h, w_hh_t)
            i, f, g, o = gates.chunk(4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class LSTMScoreNetwork(_Network):
    """The LSTM backbone (``fdtpu/models/score_models.py:336-341``): Linear
    embed, the time encoding, residual LSTM layers ``h + LSTM(h)``, Linear
    unembed; no positional encoding, no dropout."""

    def __init__(self, config: ScoreModelConfig) -> None:
        super().__init__()
        cfg = self.config = config
        self.embedder = nn.utils.skip_init(nn.Linear, cfg.n_channels, cfg.d_model)
        self.time_encoder = GaussianFourierProjection(cfg.d_model, cfg.gfp_scale)
        self.backbone = nn.ModuleList(LSTMLayer(cfg.d_model) for _ in range(cfg.num_layers))
        self.unembedder = nn.utils.skip_init(nn.Linear, cfg.d_model, cfg.n_channels)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        linear_init_(self.embedder, generator)
        linear_init_(self.unembedder, generator)
        self.time_encoder.reset_parameters(generator)
        for layer in self.backbone:
            layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        self._check_input(x)
        h = x.to(self.config._cdtype)
        h = F.linear(h, self.embedder.weight.to(h.dtype), self.embedder.bias.to(h.dtype))
        h = self.time_encoder(h, timesteps.to(h.dtype))
        for layer in self.backbone:
            h = h + layer(h)
        return self._unembed(h, x.dtype)


def init_score_model(
    cfg: ScoreModelConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> _Network:
    """Initialize the score network of ``cfg.backbone`` with torch-default
    distributions drawn from ``generator`` (on the CPU, so a seed gives the
    same weights on every device), then move it to ``device``."""
    dev = resolve_device(device)
    if cfg.backbone == "transformer":
        impl = resolve_attention_impl(cfg.attention_impl, cfg.head_dim, dev.type)
        net: _Network = ScoreNetwork(cfg, impl)
    elif cfg.backbone == "mlp":
        net = MLPScoreNetwork(cfg)
    elif cfg.backbone == "lstm":
        net = LSTMScoreNetwork(cfg)
    else:
        raise ValueError(f"backbone must be transformer, mlp or lstm, got {cfg.backbone!r}")
    net.reset_parameters(generator)
    return net.to(dev).eval().requires_grad_(False)


def _check_transformer(network: _Network, what: str) -> None:
    if network.config.backbone != "transformer":
        raise ValueError(f"{what} applies to the transformer backbone, not "
                         f"{network.config.backbone!r}")


def score_apply(
    network: _Network,
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
    _check_transformer(network, "KV caching")
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
    _check_transformer(network, "token caching")
    return network.forward_topk(x, timesteps, kv_cache, idx), kv_cache


def param_count(network: nn.Module) -> int:
    return sum(p.numel() for p in network.parameters())


@dataclasses.dataclass
class ScoreModel:
    """Bundle of (config, network, scheduler), the analog of the JAX
    ``ScoreModel`` dataclass."""

    config: ScoreModelConfig
    network: _Network
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
