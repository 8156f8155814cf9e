"""Block-diagonal multi-head attention forward: kernel B1 and its plain version.

Replaces the Pallas TPU kernel ``blockdiag_mha``
(``fdtpu/kernels/blockdiag_attention.py:172-266``) with a hand-written CUDA
kernel for Hopper, ``csrc/blockdiag_attention.cu`` (design and bound in its
header).  Same public contract and layouts::

    blockdiag_mha(q, k, v, shift=True)
        q (B, T, D) merged heads, k (B, H, Dh, T), v (B, H, T, Dh)
        -> (B, T, D) in q's dtype (float32 or bfloat16)

per head ``softmax(q_h k_h / √Dh) v_h`` with float32 scores, max, exp and
sums, a 1e-30 clamp on the denominator, and ``shift=False`` computing
``exp(s)`` without the max.  The row max is taken over the real keys only;
the TPU kernel's zero-padded key columns lift it to ≥ 0, a packing artifact
that only shows when every score of a row underflows (the TPU kernel then
returns 0, this one the true softmax average).

A CPU tensor goes to :func:`blockdiag_mha_plain`; a CUDA tensor launches the
kernel or raises — there is no fallback.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from fdtpu_torch.kernels import build

SOURCE = "blockdiag_attention"
MAX_HEAD_DIM = 32
SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block may use
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_lib = None


def blockdiag_mha_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, shift: bool = True
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract (float32 inside)."""
    b, t, d = q.shape
    h, dh = k.shape[1], k.shape[2]
    qh = q.float().reshape(b, t, h, dh)
    scores = torch.einsum("bqhd,bhdk->bhqk", qh, k.float()) / math.sqrt(dh)
    if shift:
        scores = scores - scores.amax(dim=-1, keepdim=True)
    w = torch.exp(scores)
    denom = w.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # (B, H, T, 1)
    out = torch.einsum("bhqk,bhkd->bqhd", w, v.float()) / denom.permute(0, 2, 1, 3)
    return out.reshape(b, t, d).to(q.dtype)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 3 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"expected q (B,T,D), k (B,H,Dh,T), v (B,H,T,Dh); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, t, d = q.shape
    h, dh = k.shape[1], k.shape[2]
    if k.shape != (b, h, dh, t) or v.shape != (b, h, t, dh) or d != h * dh:
        raise ValueError(
            f"inconsistent shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}: need k (B,H,Dh,T), v (B,H,T,Dh), D = H·Dh"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, {v.device}")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        fn = lib.fdtpu_blockdiag_mha_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def blockdiag_mha_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, shift: bool = True
) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors (no fallback)."""
    global launches
    b, t, d = q.shape
    h, dh = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"blockdiag_mha kernel takes float32 or bfloat16, got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("blockdiag_mha kernel needs contiguous q, k, v")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "blockdiag_mha has no backward kernel yet (B2/B3, the training "
            "slice in ROADMAP.md); run it under torch.no_grad()"
        )
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"blockdiag_mha kernel takes head_dim 1..{MAX_HEAD_DIM}, got {dh}")
    smem = 2 * 4 * dh * t
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"blockdiag_mha kernel stages K/V of T={t}, Dh={dh} in {smem} bytes "
            f"of shared memory, over the {SMEM_LIMIT}-byte limit"
        )
    if b > 65535 or h > 65535:
        raise ValueError(f"blockdiag_mha kernel grid takes B, H <= 65535, got {b}, {h}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().fdtpu_blockdiag_mha_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, t, h, dh, int(shift), q.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"blockdiag_mha kernel launch failed: cudaError_t {err}")
    launches += 1
    return out


def blockdiag_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, shift: bool = True
) -> torch.Tensor:
    """Fused block-diagonal attention (contract in the module docstring)."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return blockdiag_mha_plain(q, k, v, shift)
    if q.device.type != "cuda":
        raise ValueError(f"blockdiag_mha runs on cuda or cpu tensors, got {q.device}")
    return blockdiag_mha_cuda(q, k, v, shift)
