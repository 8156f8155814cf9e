"""The FFN sublayer of the post-norm encoder layer: kernel F1 and its plain
version.

Replaces no TPU kernel: the JAX package leaves the FFN to XLA.  On the card
the same composition was two cuBLAS sgemms, a ReLU pass and the residual and
LayerNorm passes, with the (M, F) hidden written to device memory and read
back three times a layer; ``csrc/ffn_block.cu`` (design and bound in its
header) computes it in one kernel that keeps the hidden on chip.  Contract::

    ffn_block(x, w1, b1, w2, b2, gamma, beta, eps)
        x (..., D) the rows after norm1, w1 (F, D), b1 (F,), w2 (D, F),
        b2, gamma and beta (D,), one dtype
        -> layer_norm(x + linear(relu(linear(x, w1, b1)), w2, b2), gamma, beta, eps)

the tail of :meth:`~fdtpu_torch.models.transformer.EncoderLayer._block` when
no dropout acts, with :func:`layer_norm` the encoder's LayerNorm (float32
statistics).  The kernel takes float32 at widths 1..``MAX_WIDTH``, any F and
any row count M (the product of x's leading dimensions); it adds in another
order than cuBLAS, with plain float32 FMAs (no TF32), and is deterministic.

The contract is a registered operator, ``torch.ops.fdtpu.ffn_block``
(``torch.library``): its CPU implementation is :func:`ffn_block_plain`, the
layer's composition op for op, its CUDA one launches the kernel or raises —
there is no fallback — and a fake implementation gives the shape, so that
``torch.export`` traces the sampling program through it
(:mod:`fdtpu_torch.serve`).  :func:`ffn_block` checks the shapes and calls
the operator.  ``launches`` counts the kernel's launches.  The kernel records
no gradient: it serves the forwards that run without one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from fdtpu_torch.kernels import build

SOURCE = "ffn_block"
MAX_WIDTH = 72

launches = 0
_lib: Optional[ctypes.CDLL] = None
# The operator's registration (``torch.library``), kept alive with the module.
_OPS = torch.library.Library("fdtpu", "FRAGMENT")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last dimension with float32 statistics; the
    normalized value is cast back to x's dtype before the scale and bias."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return normed.to(x.dtype) * weight.to(x.dtype) + bias.to(x.dtype)


def ffn_block_plain(x, w1, b1, w2, b2, gamma, beta, eps: float) -> torch.Tensor:
    """The encoder layer's FFN tail without dropout, op for op."""
    ff = torch.relu(F.linear(x, w1, b1))
    return layer_norm(x + F.linear(ff, w2, b2), gamma, beta, eps)


def _check_shapes(x, w1, b1, w2, b2, gamma, beta) -> None:
    if x.ndim < 1 or w1.ndim != 2:
        raise ValueError(f"expected x (..., D) and w1 (F, D); got {tuple(x.shape)}, "
                         f"{tuple(w1.shape)}")
    f, d = w1.shape
    if (x.shape[-1] != d or b1.shape != (f,) or w2.shape != (d, f) or b2.shape != (d,)
            or gamma.shape != (d,) or beta.shape != (d,)):
        raise ValueError(
            f"inconsistent shapes: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 "
            f"{tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}, gamma "
            f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}: need w1 (F, D), b1 (F,), "
            f"w2 (D, F), b2, gamma, beta (D,) with x's D")
    if not x.dtype == w1.dtype == b1.dtype == w2.dtype == b2.dtype == gamma.dtype == beta.dtype:
        raise TypeError("ffn_block's tensors differ in dtype: "
                        f"{[t.dtype for t in (x, w1, b1, w2, b2, gamma, beta)]}")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build.build(list(build.LAYER_SOURCES))
        lib = build.load(SOURCE)
        lib.fdtpu_ffn_block.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                          ctypes.c_void_p]
        )
        lib.fdtpu_ffn_block.restype = ctypes.c_int
        lib.fdtpu_ffn_block_splits.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.fdtpu_ffn_block_splits.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=256)
def split_count(rows: int, width: int, hidden: int, index: int) -> int:
    """The blocks a row tile's hidden is split across for ``rows`` rows of
    ``width`` and ``hidden`` on card ``index``: the library's choice from the
    shape and the card's resident blocks (``choose_splits`` in
    ``csrc/ffn_block.cu``), 1 to 16."""
    out = ctypes.c_int(1)
    err = _library().fdtpu_ffn_block_splits(rows, width, hidden, index, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"ffn_block split count failed: cudaError_t {err}")
    return out.value


def _check_kernel_inputs(x, w1, *rest) -> None:
    """What the kernel refuses: tensors on two devices, another dtype than
    float32, a strided tensor, a width over ``MAX_WIDTH``, M·D or F·D past
    an int32."""
    d = x.shape[-1]
    if not all(t.device == x.device for t in (w1, *rest)):
        raise ValueError("ffn_block's tensors differ in device: "
                         f"{[t.device for t in (x, w1, *rest)]}")
    if x.dtype != torch.float32:
        raise TypeError(f"ffn_block kernel takes float32, got {x.dtype}")
    if not all(t.is_contiguous() for t in (x, w1, *rest)):
        raise ValueError("ffn_block kernel needs contiguous tensors")
    if not 1 <= d <= MAX_WIDTH:
        raise ValueError(f"ffn_block kernel takes widths 1..{MAX_WIDTH}, got {d}")
    if x.numel() >= 2**31 or w1.numel() >= 2**31:
        raise ValueError(f"ffn_block kernel takes fewer than 2^31 elements a tensor, got "
                         f"{x.numel()} and {w1.numel()}")


def ffn_block_cuda(x, w1, b1, w2, b2, gamma, beta, eps: float) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors (no fallback), the hidden
    split as :func:`split_count` chooses for the shape."""
    global launches
    _check_kernel_inputs(x, w1, b1, w2, b2, gamma, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2, gamma,
                                                                 beta)):
        raise NotImplementedError(
            "ffn_block's kernel records no gradient; run it under torch.no_grad()")
    f, d = w1.shape
    out = torch.empty_like(x)
    m = x.numel() // d
    if m == 0:
        return out
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    splits = split_count(m, d, f, index)
    part = torch.empty((splits, m, d), dtype=x.dtype, device=x.device) if splits > 1 else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().fdtpu_ffn_block(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, m, d, f, splits, eps, index, stream,
    )
    if err != 0:
        raise RuntimeError(f"ffn_block kernel launch failed: cudaError_t {err}")
    launches += 1
    return out


_OPS.define("ffn_block(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor gamma, "
            "Tensor beta, float eps) -> Tensor")
_OPS.impl("ffn_block", ffn_block_plain, "CPU")
_OPS.impl("ffn_block", ffn_block_cuda, "CUDA")


@torch.library.register_fake("fdtpu::ffn_block")
def _ffn_block_fake(x, w1, b1, w2, b2, gamma, beta, eps):
    return torch.empty_like(x)


def ffn_block(x, w1, b1, w2, b2, gamma, beta, eps: float) -> torch.Tensor:
    """The FFN tail (contract in the module docstring)."""
    _check_shapes(x, w1, b1, w2, b2, gamma, beta)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ffn_block runs on cuda or cpu tensors, got {x.device}")
    return torch.ops.fdtpu.ffn_block.default(x, w1, b1, w2, b2, gamma, beta, float(eps))
