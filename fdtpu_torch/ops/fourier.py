"""Orthonormal real-DFT packing (port of ``fdtpu/ops/fourier.py:29-160``).

Packing convention: a real series of length ``T`` maps to
``[Re(0..Nyq) ‖ Im(1..Nyq-1)]`` along the time axis, a real tensor of the same
shape ``(B, T, C)``.  The DC (and, for even ``T``, Nyquist) imaginary parts are
identically zero for real input and are dropped.

The JAX package carries a matmul DFT because its TPU runtime has no FFT op;
the GPU has cuFFT, so the port uses ``torch.fft`` on every device.
"""

from __future__ import annotations

import math

import torch


def n_real_components(max_len: int) -> int:
    """Number of non-redundant real (cosine) components: T//2 + 1."""
    return max_len // 2 + 1


def packed_freq_index(max_len: int, device=None) -> torch.Tensor:
    """rfft bin index of each packed component: [0..Nyq, 1..] (length T)."""
    n_real = n_real_components(max_len)
    return torch.cat(
        [
            torch.arange(n_real, device=device),
            torch.arange(1, max_len - n_real + 1, device=device),
        ]
    )


def dft(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal real DFT of ``(batch, max_len, n_channels)`` packed into a
    real tensor of the same shape."""
    if x.is_complex():
        x = x.real
    max_len = x.shape[1]
    xf = torch.fft.rfft(x, dim=1, norm="ortho")
    re = xf.real
    im = xf.imag[:, 1:, :]
    if max_len % 2 == 0:
        im = im[:, :-1, :]
    x_tilde = torch.cat([re, im], dim=1)
    assert x_tilde.shape == x.shape
    return x_tilde


def idft(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dft`."""
    max_len = x.shape[1]
    n_real = math.ceil((max_len + 1) / 2)
    x_re = x[:, :n_real, :]
    zero = torch.zeros_like(x[:, :1, :])
    parts = [zero, x[:, n_real:, :]]
    if max_len % 2 == 0:
        parts.append(zero)
    x_im = torch.cat(parts, dim=1)
    x_time = torch.fft.irfft(torch.complex(x_re, x_im), n=max_len, dim=1, norm="ortho")
    assert x_time.shape == x.shape
    return x_time
