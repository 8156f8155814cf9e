"""Orthonormal real-DFT packing and the spectral ops (port of
``fdtpu/ops/fourier.py:29-174, 237-370``).

Packing convention: a real series of length ``T`` maps to
``[Re(0..Nyq) ‖ Im(1..Nyq-1)]`` along the time axis, a real tensor of the same
shape ``(B, T, C)``.  The DC (and, for even ``T``, Nyquist) imaginary parts are
identically zero for real input and are dropped.

The JAX package carries a matmul DFT because its TPU runtime has no FFT op;
the GPU has cuFFT, so the port uses ``torch.fft`` on every device, and the
FreqCa decomposition follows the reference's FFT branch.
"""

from __future__ import annotations

import math
from typing import Optional, Union

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


def _packed_re_im(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Real and imaginary rfft parts ``(B, T//2+1, C)`` of a packed spectrum,
    with the dropped DC (and even-length Nyquist) imaginary parts as zeros."""
    max_len = x.shape[1]
    n_real = math.ceil((max_len + 1) / 2)
    zero = torch.zeros_like(x[:, :1, :])
    parts = [zero, x[:, n_real:, :]]
    if max_len % 2 == 0:
        parts.append(zero)
    return x[:, :n_real, :], torch.cat(parts, dim=1)


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
    x_re, x_im = _packed_re_im(x)
    x_time = torch.fft.irfft(torch.complex(x_re, x_im), n=x.shape[1], dim=1, norm="ortho")
    assert x_time.shape == x.shape
    return x_time


def spectral_density(x: torch.Tensor, apply_dft: bool = True) -> torch.Tensor:
    """Per-frequency energy ``Re² + Im²``, ``(batch, T//2 + 1, n_channels)``
    (``fdtpu/ops/fourier.py:159-174``)."""
    re, im = _packed_re_im(dft(x) if apply_dft else x)
    return re**2 + im**2


def frequency_decompose_fft(
    x: torch.Tensor, low_freq_ratio: float = 0.3
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split ``(B, L, D)`` or ``(L, D)`` features along the sequence axis into
    the parts below and above the first ``max(1, int(n_freq · ratio))`` rfft
    bins (``fdtpu/ops/fourier.py:237-267``, its FFT branch: both parts are
    inverse transforms of the masked spectrum, so ``x_high`` is not
    ``x − x_low`` to the last bit)."""
    was_2d = x.ndim == 2
    if was_2d:
        x = x[None]
    seq_len = x.shape[1]
    n_freq = seq_len // 2 + 1
    n_low = max(1, int(n_freq * low_freq_ratio))
    xf = torch.fft.rfft(x, dim=1, norm="ortho")
    shape = (1, n_freq) + (1,) * (x.ndim - 2)
    low_mask = (torch.arange(n_freq, device=x.device) < n_low).to(x.dtype).view(shape)
    x_low = torch.fft.irfft(xf * low_mask, n=seq_len, dim=1, norm="ortho")
    x_high = torch.fft.irfft(xf * (1 - low_mask), n=seq_len, dim=1, norm="ortho")
    if was_2d:
        x_low, x_high = x_low[0], x_high[0]
    return x_low, x_high


def frequency_decompose_dct(
    x: torch.Tensor, low_freq_ratio: float = 0.3
) -> tuple[torch.Tensor, torch.Tensor]:
    """The DCT variant, which delegates to the FFT decomposition as the JAX
    package's does (its DCT body is dead code)."""
    return frequency_decompose_fft(x, low_freq_ratio)


def hermite_polynomials(s: torch.Tensor, order: int = 2) -> torch.Tensor:
    """Physicists' Hermite polynomials H_0..H_order at ``s`` ((K,) or
    (batch, K)), by H_{n+1} = 2s·H_n − 2n·H_{n−1}: ``(order+1, K)`` or
    ``(order+1, batch, K)``."""
    was_1d = s.ndim == 1
    if was_1d:
        s = s[None]
    rows = [torch.ones_like(s)]
    if order >= 1:
        rows.append(2 * s)
    for n in range(1, order):
        rows.append(2 * s * rows[n] - 2 * n * rows[n - 1])
    h = torch.stack(rows, dim=0)
    return h[:, 0, :] if was_1d else h


def hermite_design_matrix(s: torch.Tensor, order: int) -> torch.Tensor:
    """Design matrix ``(K, order+1)`` of Hermite polynomials at ``s (K,)``."""
    return hermite_polynomials(s, order=order).T


def predict_hermite(
    history: torch.Tensor,
    timesteps: torch.Tensor,
    target_timestep: torch.Tensor,
    order: int = 2,
    valid: Optional[torch.Tensor] = None,
    clip_target: Union[bool, torch.Tensor] = True,
) -> torch.Tensor:
    """Least-squares Hermite extrapolation of a feature history (FreqCa;
    ``fdtpu/ops/fourier.py:309-370``).

    ``history`` is ``(K, ...)``, oldest first, at ``timesteps (K,)``;
    ``valid`` (K,) marks the live entries of a ring that is not full yet
    (zero-weight rows in the normal equations); ``clip_target`` (a bool or a
    bool tensor) clips the normalized target into the history's span.  A
    degenerate span returns the most recent entry.  Nothing here reads the
    device: the solve does not check its result on the host.
    """
    k = history.shape[0]
    if k < 2:
        return history[-1]
    if valid is None:
        valid = torch.ones((k,), dtype=torch.bool, device=history.device)
    w = valid.to(history.dtype)
    big = torch.finfo(timesteps.dtype).max
    t_min = torch.min(torch.where(valid, timesteps, big))
    t_max = torch.max(torch.where(valid, timesteps, -big))
    span = t_max - t_min
    safe_span = torch.where(span == 0, 1.0, span)
    s_hist = torch.clamp(2 * (timesteps - t_min) / safe_span - 1, -1.0, 1.0)
    s_target = 2 * (target_timestep - t_min) / safe_span - 1
    if isinstance(clip_target, torch.Tensor):
        s_target = torch.where(clip_target, torch.clamp(s_target, -1.0, 1.0), s_target)
    elif clip_target:
        s_target = torch.clamp(s_target, -1.0, 1.0)

    h_matrix = hermite_design_matrix(s_hist, order) * w[:, None]  # (K, order+1)
    h_target = hermite_polynomials(s_target.reshape(1), order=order)[:, 0]  # (order+1,)
    eye = torch.eye(order + 1, dtype=history.dtype, device=history.device)
    hth = h_matrix.T @ h_matrix + eye * 1e-6
    flat = history.reshape(k, -1) * w[:, None]
    coeffs = torch.linalg.solve_ex(hth, h_matrix.T @ flat, check_errors=False).result
    prediction = (h_target @ coeffs).reshape(history.shape[1:])
    return torch.where(span == 0, history[-1], prediction)
