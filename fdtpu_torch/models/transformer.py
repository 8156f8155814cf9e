"""Post-norm transformer encoder layer and its cached modes (port of
``fdtpu/models/transformer.py:44-274``).

Semantics follow torch's ``nn.TransformerEncoderLayer`` defaults: post-norm,
ReLU, dim_feedforward 2048, LayerNorm eps 1e-5 (statistics in float32, cast
back to the compute dtype before scale and bias), dropout 0.1.  Dropout acts
only in ``forward(x, train=True, generator=g)``, at the three sites of the
JAX layer (attention output, FFN hidden, FFN output): a keep-mask drawn from
``g`` and ``x / keep`` where kept, as ``_maybe_dropout``
(``fdtpu/models/transformer.py:109-116``).  Without a generator there is no
dropout, as the JAX layer has none without a key.

``forward`` is the uncached layer.  The E²-CRF cache's forwards take the
layer's K/V store, ``(k, v)`` each ``(B, T, H, Dh)``, and update it in place
(the JAX layer returns a new one):

* :meth:`EncoderLayer.forward_cached` — ``MODE_FULL`` writes fresh K/V of
  every token, ``MODE_MIXED`` those of the tokens under ``recompute_mask``,
  ``MODE_CACHED`` attends fresh queries to the stored K/V unchanged;
* :meth:`EncoderLayer.forward_topk` — the token level's budget rows: their
  K/V are written into the store and they attend to all T stored keys.

``attention_impl``:

* ``"einsum"`` — plain attention over ``(B, T, H, Dh)`` in every mode
  (:func:`fdtpu_torch.kernels.attention.mha_plain`).
* ``"blockdiag"`` / ``"blockdiag_noshift"`` — hand-written kernels in every
  mode: the full-attention forward through ``blockdiag_mha_trainable``
  (:mod:`fdtpu_torch.kernels.blockdiag_attention`: forward B1, backward B2),
  whose projections write straight into its layouts (q merged, k
  ``(B, H, Dh, T)``, v ``(B, H, T, Dh)``); the MIXED, CACHED and TOPK
  attention through ``fused_mha`` (B4).  ``noshift`` drops B1's max
  subtraction; it was measured non-finite on full sampling chains and is kept
  for parity only.  Both reach the kernels through their registered
  operators (``fdtpu::blockdiag_mha``, ``fdtpu::fused_mha``), on every path:
  eager, captured in CUDA graphs, and traced by ``torch.export``
  (:mod:`fdtpu_torch.serve`, which hands the in-place store updates copies).

Every mode's FFN tail, ``norm2(x + linear2(relu(linear1(x))))``, goes through
the registered operator ``fdtpu::ffn_block`` (:mod:`fdtpu_torch.kernels.ffn`:
kernel F1 on the card, this composition op for op on the CPU) when no dropout
acts, no gradient is recorded, there is no model axis and the compute dtype is
float32 at a width F1 takes; otherwise the layer composes it as before.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fdtpu_torch.dist.parallel import draw
from fdtpu_torch.kernels.attention import fused_mha, mha_plain
from fdtpu_torch.kernels.blockdiag_attention import blockdiag_mha_trainable
from fdtpu_torch.kernels.ffn import MAX_WIDTH as FFN_MAX_WIDTH
from fdtpu_torch.kernels.ffn import ffn_block, layer_norm
from fdtpu_torch.models.initializers import linear_init_, xavier_uniform_

ATTENTION_IMPLS = ("einsum", "blockdiag", "blockdiag_noshift")
KERNEL_IMPLS = ("blockdiag", "blockdiag_noshift")

MODE_FULL = 0
MODE_MIXED = 1
MODE_CACHED = 2

KVStore = tuple[torch.Tensor, torch.Tensor]


class LayerNorm(nn.Module):
    """LayerNorm with float32 statistics; the normalized value is cast back
    to the input dtype before the (compute-dtype) scale and bias."""

    def __init__(self, d_model: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d_model))
        self.bias = nn.Parameter(torch.zeros(d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def _lin(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _dropout(
    x: torch.Tensor, rate: float, train: bool, generator: Optional[torch.Generator],
    cols: bool = False,
) -> torch.Tensor:
    """Inverted dropout with a keep-mask drawn from ``generator``; the
    identity unless training with a positive rate and a generator.  A
    :class:`~fdtpu_torch.dist.parallel.ShardedGenerator` draws the global
    batch's mask (``cols``: of the whole width of a column-parallel
    activation) and keeps this rank's part."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = draw(torch.rand, x.shape, generator, x.device, cols=cols) < keep
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
        # Set by fdtpu_torch.dist.tensor_parallel.parallelize: the model axis
        # whose ranks each hold n_head heads and their share of the FFN.
        self.model_axis = None

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

    def _in_proj(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        return self.in_proj_weight.to(dtype), self.in_proj_bias.to(dtype)

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) → queries (B, T, H, Dh)."""
        b, t, d = x.shape
        w, bias = self._in_proj(x.dtype)
        return F.linear(x, w[:d], bias[:d]).reshape(b, t, self.n_head, d // self.n_head)

    def project_kv(self, x: torch.Tensor) -> KVStore:
        """(B, T, D) → keys and values, each (B, T, H, Dh)."""
        b, t, d = x.shape
        w, bias = self._in_proj(x.dtype)
        kv = F.linear(x, w[d:], bias[d:])
        return tuple(a.reshape(b, t, self.n_head, d // self.n_head) for a in kv.split(d, -1))

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Attention of the cached modes: kernel B4 under a kernel
        ``attention_impl``, the plain version under ``"einsum"``."""
        if self.attention_impl in KERNEL_IMPLS:
            return fused_mha(q, k, v)
        return mha_plain(q, k, v)

    def _self_attention(self, x: torch.Tensor, store: Optional[KVStore] = None) -> torch.Tensor:
        """Full attention over (B, T, D); with ``store``, the fresh K/V are
        written into it in the standard (B, T, H, Dh) layout."""
        b, t, d_in = x.shape
        w, bias = self._in_proj(x.dtype)
        # The width of this rank's heads (all of d_model without a model axis).
        d = w.shape[0] // 3
        h = self.n_head
        dh = d // h
        if self.attention_impl == "einsum":
            qkv = F.linear(x, w, bias)
            q, k, v = (a.reshape(b, t, h, dh) for a in qkv.split(d, dim=-1))
            if store is not None:
                store[0].copy_(k)
                store[1].copy_(v)
            return mha_plain(q, k, v).reshape(b, t, d)
        # Kernel layouts: q merged (B, T, D), k (B, H, Dh, T), v (B, H, T, Dh).
        q = F.linear(x, w[:d], bias[:d])
        k = torch.einsum("btc,hec->bhet", x, w[d:2 * d].reshape(h, dh, d_in))
        k = (k + bias[d:2 * d].reshape(1, h, dh, 1)).contiguous()
        v = torch.einsum("btc,hec->bhte", x, w[2 * d:].reshape(h, dh, d_in))
        v = (v + bias[2 * d:].reshape(1, h, 1, dh)).contiguous()
        if store is not None:
            # One transposed copy of each per layer and refresh: the store
            # keeps the standard layout that the cached modes attend to.
            store[0].copy_(k.permute(0, 3, 1, 2))
            store[1].copy_(v.permute(0, 2, 1, 3))
        return blockdiag_mha_trainable(q, k, v, shift=self.attention_impl == "blockdiag")

    def _block(
        self,
        x: torch.Tensor,
        attn: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Output projection, residuals, LayerNorms and FFN around the
        attention output ``attn`` (B, T, D) of ``x``."""
        rate = self.dropout
        attn = self._row(attn, self.out_proj)
        x = self.norm1(x + _dropout(attn, rate, train, generator))
        params = self._ffn_params()
        if self._ffn_kernel(x, params, train, generator):
            return ffn_block(x, *params, self.norm2.eps)
        ff = _dropout(torch.relu(_lin(self._to_model(x), self.linear1)), rate, train, generator,
                      cols=True)
        ff = self._row(ff, self.linear2)
        return self.norm2(x + _dropout(ff, rate, train, generator))

    def _ffn_kernel(self, x: torch.Tensor, params: tuple[torch.Tensor, ...], train: bool,
                    generator: Optional[torch.Generator]) -> bool:
        """Whether the FFN tail goes through ``fdtpu::ffn_block`` (kernel F1
        on the card): no dropout acts, no gradient is recorded, no model
        axis, and float32 (input and parameters) at a width the kernel
        takes.  Every other call (training steps, the tensor-parallel mesh,
        bfloat16) composes it."""
        dropout = train and self.dropout > 0.0 and generator is not None
        return (not dropout and not torch.is_grad_enabled() and self.model_axis is None
                and x.dtype == torch.float32 and x.shape[-1] <= FFN_MAX_WIDTH
                and all(p.dtype == torch.float32 for p in params))

    def _ffn_params(self) -> tuple[torch.Tensor, ...]:
        """``fdtpu::ffn_block``'s parameters: linear1's, linear2's, norm2's."""
        return (self.linear1.weight, self.linear1.bias, self.linear2.weight, self.linear2.bias,
                self.norm2.weight, self.norm2.bias)

    def _to_model(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel projection: ``x`` itself, or under
        a model axis the identity whose backward sums the ranks' gradients."""
        if self.model_axis is None:
            return x
        from fdtpu_torch.dist.tensor_parallel import copy_to_model

        return copy_to_model(x, self.model_axis.group)

    def _row(self, a: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        """A row-parallel output projection: ``layer(a)``, or under a model
        axis the ranks' partial products summed, then the bias."""
        if self.model_axis is None:
            return _lin(a, layer)
        from fdtpu_torch.dist.tensor_parallel import reduce_from_model

        part = F.linear(a, layer.weight.to(a.dtype))
        return reduce_from_model(part, self.model_axis.group) + layer.bias.to(a.dtype)

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """One post-norm encoder layer over (B, T, D) hidden states; dropout
        only with ``train`` and a ``generator``."""
        return self._block(x, self._self_attention(self._to_model(x)), train, generator)

    def forward_cached(
        self,
        x: torch.Tensor,
        store: KVStore,
        mode: int,
        recompute_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The layer in one of the KV cache's modes (no dropout).  ``store``
        is this layer's ``(k, v)``, each (B, T, H, Dh), updated in place;
        ``recompute_mask`` (T,) bool selects the tokens MODE_MIXED refreshes."""
        if mode == MODE_FULL:
            return self._block(x, self._self_attention(x, store))
        b, t, d = x.shape
        q = self.project_q(x)
        if mode == MODE_MIXED:
            k_fresh, v_fresh = self.project_kv(x)
            m = recompute_mask[None, :, None, None]
            # In place: the masked tokens take fresh K/V, the rest keep theirs.
            torch.where(m, k_fresh, store[0], out=store[0])
            torch.where(m, v_fresh, store[1], out=store[1])
        elif mode != MODE_CACHED:
            raise ValueError(f"mode must be MODE_FULL, MODE_MIXED or MODE_CACHED, got {mode}")
        return self._block(x, self._attend(q, *store).reshape(b, t, d))

    def forward_topk(self, x_rows: torch.Tensor, store: KVStore, idx: torch.Tensor) -> torch.Tensor:
        """Token-budget layer: attention and FFN for the ``idx`` rows only.

        ``x_rows`` (B, k, D) are the hidden states of tokens ``idx`` (k,);
        their fresh K/V are written into the store (in place, the other rows
        untouched) and their queries attend to all T stored keys."""
        b, n, d = x_rows.shape
        q = self.project_q(x_rows)
        k_new, v_new = self.project_kv(x_rows)
        store[0].index_copy_(1, idx, k_new)
        store[1].index_copy_(1, idx, v_new)
        return self._block(x_rows, self._attend(q, *store).reshape(b, n, d))
