"""Block-diagonal multi-head attention: kernels B1 (forward) and B2
(backward), their plain versions, and B3, the autograd glue over both.

Replaces the Pallas TPU kernels ``blockdiag_mha``
(``fdtpu/kernels/blockdiag_attention.py:172-266``) and ``blockdiag_mha_bwd``
(``:354-407``) with hand-written CUDA kernels for Hopper,
``csrc/blockdiag_attention.cu`` and ``csrc/blockdiag_attention_bwd.cu``
(design and bound in their headers), and the custom VJP
``blockdiag_mha_trainable`` (``:410-433``) with :class:`BlockdiagMHA`.
Same public contract and layouts::

    blockdiag_mha(q, k, v, shift=True)
        q (B, T, D) merged heads, k (B, H, Dh, T), v (B, H, T, Dh)
        -> (B, T, D) in q's dtype (float32 or bfloat16)

per head ``softmax(q_h k_h / √Dh) v_h`` with float32 scores, max, exp and
sums, a 1e-30 clamp on the denominator, and ``shift=False`` computing
``exp(s)`` without the max.  The row max is taken over the real keys only;
the TPU kernel's zero-padded key columns lift it to ≥ 0, a packing artifact
that only shows when every score of a row underflows (the TPU kernel then
returns 0, this one the true softmax average).

    blockdiag_mha_bwd(q, k, v, g) -> (dq, dk, dv)
        g (B, T, D) the cotangent of the output; dq (B, T, D), dk (B, H, Dh, T),
        dv (B, H, T, Dh) in the input dtype

recomputes the softmax weights W (always shifted, whatever the forward's
``shift``) and returns ``dq = dS·K``, ``dk = qᵀ·dS``, ``dv = Wᵀ·g`` with
``dS = W ⊙ (g·Vᵀ − Σ_j W⊙g·Vᵀ) / √Dh``, float32 inside.

Both kernels take head_dim 1..32 and T up to ``MAX_SEQ``: the keys (and
B2's rows) stream through shared memory in tiles, so shared memory no longer
caps T.  The wrapper hands B2 a float32 (B, H, 3, T) scratch; the kernel
keeps its row statistics (12 bytes a row) in shared memory and uses the
scratch only where they and its two 16 KB tiles overflow it (past T =
16,640 at any head_dim).

Both contracts are registered operators, ``torch.ops.fdtpu.blockdiag_mha``
and ``torch.ops.fdtpu.blockdiag_mha_bwd`` (``torch.library``): the CPU
implementation is the plain version, the CUDA one launches the kernel or
raises — there is no fallback — and a fake implementation gives shapes and
dtypes, so that ``torch.export`` traces a model through them
(:mod:`fdtpu_torch.serve`).  The wrappers :func:`blockdiag_mha` and
:func:`blockdiag_mha_bwd` check the shapes and call the operators; every
path of the port reaches the kernels through them.  ``launches`` and
``launches_bwd`` count kernel launches; ``launches_trainable`` counts
backward passes of :class:`BlockdiagMHA` on the card.  The forward kernel
refuses inputs that require a gradient: :func:`blockdiag_mha_trainable` is
the one way to one.
"""

from __future__ import annotations

import ctypes
import math

import torch

from fdtpu_torch.kernels import build

SOURCE = "blockdiag_attention"
SOURCE_BWD = "blockdiag_attention_bwd"
MAX_HEAD_DIM = 32
# Longest T either kernel takes: every index in them, T² included, fits an int32.
MAX_SEQ = 32_768
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
launches_bwd = 0
launches_trainable = 0
_libs: dict[str, ctypes.CDLL] = {}
# The operators' registrations (``torch.library``), kept alive with the module.
_OPS = torch.library.Library("fdtpu", "FRAGMENT")


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


def _library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``; the first use of either
    source builds the encoder layer's sources (``build.LAYER_SOURCES``), one
    ``nvcc`` each, in parallel."""
    lib = _libs.get(name)
    if lib is None:
        build.build(list(build.LAYER_SOURCES))
        lib = build.load(name)
        if name == SOURCE:
            fn = lib.fdtpu_blockdiag_mha_fwd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        else:
            fn = lib.fdtpu_blockdiag_mha_bwd
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def _check_kernel_inputs(name: str, *tensors: torch.Tensor) -> None:
    """What both kernels refuse: another dtype, a strided input, head_dim
    over 32, T over ``MAX_SEQ``, B or H over the grid's 65535."""
    q, k = tensors[0], tensors[1]
    b, t, _ = q.shape
    h, dh = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {q.dtype}")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"{name} kernel takes head_dim 1..{MAX_HEAD_DIM}, got {dh}")
    if t > MAX_SEQ:
        raise ValueError(f"{name} kernel takes T <= {MAX_SEQ}, got {t}")
    if b > 65535 or h > 65535:
        raise ValueError(f"{name} kernel grid takes B, H <= 65535, got {b}, {h}")


def blockdiag_mha_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, shift: bool = True
) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors (no fallback)."""
    global launches
    b, t, _ = q.shape
    h, dh = k.shape[1], k.shape[2]
    _check_kernel_inputs("blockdiag_mha", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "blockdiag_mha's kernel records no gradient; differentiate through "
            "blockdiag_mha_trainable, or run it under torch.no_grad()"
        )
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library(SOURCE).fdtpu_blockdiag_mha_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, t, h, dh, int(shift), q.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"blockdiag_mha kernel launch failed: cudaError_t {err}")
    launches += 1
    return out


_OPS.define("blockdiag_mha(Tensor q, Tensor k, Tensor v, bool shift) -> Tensor")
_OPS.impl("blockdiag_mha", blockdiag_mha_plain, "CPU")
_OPS.impl("blockdiag_mha", blockdiag_mha_cuda, "CUDA")


@torch.library.register_fake("fdtpu::blockdiag_mha")
def _blockdiag_mha_fake(q, k, v, shift):
    return torch.empty_like(q)


def blockdiag_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, shift: bool = True
) -> torch.Tensor:
    """Fused block-diagonal attention (contract in the module docstring)."""
    _check_shapes(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blockdiag_mha runs on cuda or cpu tensors, got {q.device}")
    return torch.ops.fdtpu.blockdiag_mha.default(q, k, v, shift)


def blockdiag_mha_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel's contract (float32
    inside; the softmax recomputed with the row max over the real keys)."""
    b, t, d = q.shape
    h, dh = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    qh = q.float().reshape(b, t, h, dh)
    gh = g.float().reshape(b, t, h, dh)
    kf, vf = k.float(), v.float()
    w = torch.softmax(torch.einsum("bqhd,bhdk->bhqk", qh, kf) * scale, dim=-1)
    dw = torch.einsum("bqhd,bhkd->bhqk", gh, vf)
    r = (dw * w).sum(dim=-1, keepdim=True)
    ds = w * (dw - r) * scale
    dq = torch.einsum("bhqk,bhdk->bqhd", ds, kf).reshape(b, t, d)
    dk = torch.einsum("bqhd,bhqk->bhdk", qh, ds)
    dv = torch.einsum("bhqk,bqhd->bhkd", w, gh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def blockdiag_mha_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the Hopper backward kernel on CUDA tensors (no fallback)."""
    global launches_bwd
    b, t, _ = q.shape
    h, dh = k.shape[1], k.shape[2]
    _check_kernel_inputs("blockdiag_mha_bwd", q, k, v, g)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk, dv
    # Room for the row statistics (max, 1/sum, Σ W⊙dW); where they fit in
    # shared memory the kernel keeps them there and leaves this untouched.
    scratch = torch.empty((b, h, 3, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library(SOURCE_BWD).fdtpu_blockdiag_mha_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
        _DTYPE_CODE[q.dtype], b, t, h, dh, q.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"blockdiag_mha_bwd kernel launch failed: cudaError_t {err}")
    launches_bwd += 1
    return dq, dk, dv


def blockdiag_mha_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`blockdiag_mha` (contract in the module docstring)."""
    _check_shapes(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(
            f"g must match q: got {tuple(g.shape)} {g.dtype} on {g.device}, "
            f"q is {tuple(q.shape)} {q.dtype} on {q.device}"
        )
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blockdiag_mha_bwd runs on cuda or cpu tensors, got {q.device}")
    return torch.ops.fdtpu.blockdiag_mha_bwd.default(q, k, v, g)


_OPS.define("blockdiag_mha_bwd(Tensor q, Tensor k, Tensor v, Tensor g) -> (Tensor, Tensor, Tensor)")
_OPS.impl("blockdiag_mha_bwd", blockdiag_mha_bwd_plain, "CPU")
_OPS.impl("blockdiag_mha_bwd", blockdiag_mha_bwd_cuda, "CUDA")


@torch.library.register_fake("fdtpu::blockdiag_mha_bwd")
def _blockdiag_mha_bwd_fake(q, k, v, g):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


class BlockdiagMHA(torch.autograd.Function):
    """Forward kernel B1 and backward kernel B2 as one differentiable op
    (the two registered operators, through their wrappers).

    The forward saves only q, k and v; the backward recomputes the weights.
    ``shift`` reaches the forward only (the recomputed softmax is always
    shifted, which leaves it unchanged)."""

    @staticmethod
    def forward(ctx, q, k, v, shift):
        ctx.save_for_backward(q, k, v)
        return blockdiag_mha(q, k, v, shift)

    @staticmethod
    def backward(ctx, g):
        global launches_trainable
        q, k, v = ctx.saved_tensors
        dq, dk, dv = blockdiag_mha_bwd(q, k, v, g.contiguous())
        if q.device.type == "cuda":
            launches_trainable += 1
        return dq, dk, dv, None


def blockdiag_mha_trainable(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, shift: bool = True
) -> torch.Tensor:
    """Differentiable :func:`blockdiag_mha`: kernel forward and backward."""
    return BlockdiagMHA.apply(q, k, v, shift)
