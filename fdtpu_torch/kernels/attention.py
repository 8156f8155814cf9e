"""Fused multi-head attention over the token-major layout: kernel B4 and its
plain version.

Replaces the Pallas TPU kernel ``fused_mha`` (``fdtpu/kernels/attention.py:63-87``,
``_mha_kernel``) with a hand-written CUDA kernel for Hopper,
``csrc/fused_attention.cu`` (design and bound in its header).  Contract::

    fused_mha(q, k, v)
        q (B, Tq, H, Dh), k and v (B, Tk, H, Dh), one dtype (float32 or bfloat16)
        -> (B, Tq, H, Dh) in q's dtype

per head ``softmax(q_h k_hᵀ / √Dh) v_h`` with float32 scores, the true row max
and the division by the row sum in float32, and the weights cast to v's dtype
before the value product (float32 sums).  This is the attention of the cached
forwards (:mod:`fdtpu_torch.models.transformer`: the KV level's MIXED and
CACHED modes, Tq = Tk, and the token level's TOPK rows, Tq = ``token_budget``
against all Tk = T keys).  Unlike the Pallas kernel, Tq may differ from Tk,
and there is no batch tile: the TPU kernel's fallback to ``mha_reference``
when B is not a multiple of its tile is a tiling artifact, not ported.

The kernel takes head_dim 1..32, any Tq and Tk up to ``MAX_SEQ``: float32
runs B1's one-pass design over keys streamed through shared memory, bfloat16
tensor-core tiles (two passes past 256 keys), so shared memory caps neither.

A CPU tensor goes to :func:`mha_plain`; a CUDA tensor launches the kernel or
raises — there is no fallback.  ``launches`` counts kernel launches.  The
kernel records no gradient: it serves the sampling chains only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from fdtpu_torch.kernels import build

SOURCE = "fused_attention"
MAX_HEAD_DIM = 32
# Longest Tk the kernel takes: every key index in it fits an int32 (B1's ceiling).
MAX_SEQ = 32_768
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_lib: Optional[ctypes.CDLL] = None


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention over (B, T, H, Dh): float32 scores and
    softmax, weights cast to v's dtype before the value contraction (the JAX
    package's ``mha_reference`` and the model's ``_attention``)."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dh)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"expected q (B,Tq,H,Dh), k and v (B,Tk,H,Dh); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, h, dh = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, dh):
        raise ValueError(
            f"inconsistent shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}: need k = v = (B, Tk, H, Dh) with q's B, H, Dh"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, {v.device}")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        lib.fdtpu_fused_mha_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        lib.fdtpu_fused_mha_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernel refuses: another dtype, a strided input, head_dim over
    32, Tk outside 1..``MAX_SEQ``, B or H over the grid's 65535."""
    b, _, h, dh = q.shape
    tk = k.shape[1]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_mha kernel takes float32 or bfloat16, got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_mha kernel needs contiguous inputs")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"fused_mha kernel takes head_dim 1..{MAX_HEAD_DIM}, got {dh}")
    if not 1 <= tk <= MAX_SEQ:
        raise ValueError(f"fused_mha kernel takes 1 <= Tk <= {MAX_SEQ}, got {tk}")
    if b > 65535 or h > 65535:
        raise ValueError(f"fused_mha kernel grid takes B, H <= 65535, got {b}, {h}")


def fused_mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors (no fallback)."""
    global launches
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    _check_kernel_inputs(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "fused_mha's kernel records no gradient; run it under torch.no_grad()"
        )
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().fdtpu_fused_mha_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, tq, tk, h, dh, q.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_mha kernel launch failed: cudaError_t {err}")
    launches += 1
    return out


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused token-major attention (contract in the module docstring)."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return mha_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused_mha runs on cuda or cpu tensors, got {q.device}")
    return fused_mha_cuda(q, k, v)
