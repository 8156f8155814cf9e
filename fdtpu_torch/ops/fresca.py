"""FreSca frequency-selective score scaling (port of ``fdtpu/ops/fresca.py``).

The energy cutoff is a ``cumsum`` and a comparison, as in the JAX package,
so a call reads nothing back from the device.  The JAX package's matmul forms
of the 1-D and 2-D transforms exist because its TPU runtime has no FFT op;
the port uses ``torch.fft`` (cuFFT on the card) for both.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

Scale = Union[float, torch.Tensor]


def _cutoff_bin(enclosed: torch.Tensor, cutoff_ratio: float, total: torch.Tensor) -> torch.Tensor:
    """First index whose cumulative energy reaches ``cutoff_ratio`` of the
    total, float32; 0 when none does (the reference's degenerate case)."""
    reached = enclosed >= cutoff_ratio * total
    first = torch.argmax(reached.to(torch.int32)).to(torch.float32)
    return torch.where(torch.any(reached), first, 0.0)


def create_frequency_masks(
    n_freq: int,
    cutoff_ratio: float,
    cutoff_strategy: str = "spatial",
    freq_spectrum: Optional[torch.Tensor] = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Low-pass and high-pass float masks ``(n_freq,)`` over 1-D frequency
    bins: ``spatial`` cuts at ``cutoff_ratio · n_freq``, ``energy`` at the
    first bin whose cumulative ``|spectrum|`` reaches ``cutoff_ratio`` of the
    total."""
    if cutoff_strategy == "energy":
        if freq_spectrum is None:
            raise ValueError("freq_spectrum required for energy-based cutoff")
        device = freq_spectrum.device
    k = torch.arange(n_freq, dtype=torch.float32, device=device)
    if cutoff_strategy == "spatial":
        low = (k <= cutoff_ratio * n_freq).to(torch.float32)
    elif cutoff_strategy == "energy":
        cum = torch.cumsum(torch.abs(freq_spectrum), dim=0)
        low = (k <= _cutoff_bin(cum, cutoff_ratio, cum[-1])).to(torch.float32)
    else:
        raise ValueError(f"Unknown cutoff_strategy: {cutoff_strategy}")
    return low, 1.0 - low


def create_frequency_masks_2d(
    shape: tuple[int, int],
    cutoff_ratio: float,
    cutoff_strategy: str = "spatial",
    freq_spectrum: Optional[torch.Tensor] = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Radial low and high masks over a 2-D ``(H, n_freq_w)`` spectrum; the
    distance from DC uses the unfolded row index, as the reference does.
    ``spatial`` cuts at ``cutoff_ratio · min(H/2, n_freq_w)``; ``energy`` at
    the smallest integer radius R ≤ min(H, W)/2 whose enclosed ``|spectrum|``
    reaches ``cutoff_ratio`` of the total (a pixel at distance d is first
    enclosed by the radius ceil(d))."""
    h, n_freq_w = shape
    if cutoff_strategy == "energy":
        if freq_spectrum is None:
            raise ValueError("freq_spectrum required for energy-based cutoff")
        device = freq_spectrum.device
    kx = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    ky = torch.arange(n_freq_w, dtype=torch.float32, device=device)[None, :]
    k_dist = torch.sqrt(kx**2 + ky**2)  # (H, n_freq_w)
    if cutoff_strategy == "spatial":
        low = (k_dist <= cutoff_ratio * min(h / 2, n_freq_w)).to(torch.float32)
    elif cutoff_strategy == "energy":
        r_max = int(min(h, 2 * (n_freq_w - 1)) / 2)
        n_bins = int(math.ceil(math.hypot(h - 1, n_freq_w - 1))) + 1
        bins = torch.ceil(k_dist).to(torch.int64).reshape(-1)
        # Energy per ceil-radius: a one-hot product rather than index_add_,
        # whose atomics would sum in a different order on every call.
        one_hot = (bins[:, None] == torch.arange(n_bins, device=device)).to(freq_spectrum.dtype)
        per_radius = torch.abs(freq_spectrum).reshape(-1) @ one_hot
        enclosed = torch.cumsum(per_radius, dim=0)
        rc = _cutoff_bin(enclosed[: r_max + 1], cutoff_ratio, enclosed[-1])
        low = (k_dist <= rc).to(torch.float32)
    else:
        raise ValueError(f"Unknown cutoff_strategy: {cutoff_strategy}")
    return low, 1.0 - low


def _frequency_scale_2d(
    x: torch.Tensor, low_scale: Scale, high_scale: Scale, cutoff_ratio: float,
    cutoff_strategy: str,
) -> torch.Tensor:
    """The (B, H, W, C) branch of :func:`frequency_scale`: radial masks over
    the rfft2 spectrum (``fdtpu/ops/fresca.py:167-215``)."""
    _, h, w, _ = x.shape
    xf = torch.fft.rfft2(x, dim=(1, 2), norm="ortho")
    spectrum = torch.abs(xf).mean(dim=(0, 3)) if cutoff_strategy == "energy" else None
    low, high = create_frequency_masks_2d(
        (h, w // 2 + 1), cutoff_ratio, cutoff_strategy, spectrum, device=x.device
    )
    scale_2d = low_scale * low + high_scale * high
    return torch.fft.irfft2(xf * scale_2d[None, :, :, None], s=(h, w), dim=(1, 2), norm="ortho")


def frequency_scale(
    x: torch.Tensor,
    low_scale: Scale = 1.0,
    high_scale: Scale = 1.0,
    cutoff_ratio: float = 0.5,
    cutoff_strategy: str = "spatial",
) -> torch.Tensor:
    """Scale the low and high frequency bands of ``x`` independently: along
    the sequence axis of ``(batch, seq_len, channels)``, or radially over the
    2-D spectrum of ``(batch, H, W, channels)``."""
    if x.ndim == 4:
        return _frequency_scale_2d(x, low_scale, high_scale, cutoff_ratio, cutoff_strategy)
    seq_len = x.shape[1]
    xf = torch.fft.rfft(x, dim=1, norm="ortho")
    spectrum = torch.abs(xf).mean(dim=(0, 2)) if cutoff_strategy == "energy" else None
    low, high = create_frequency_masks(
        seq_len // 2 + 1, cutoff_ratio, cutoff_strategy, spectrum, device=x.device
    )
    low, high = low[None, :, None], high[None, :, None]
    xf_scaled = low_scale * low * xf + high_scale * high * xf
    return torch.fft.irfft(xf_scaled, n=seq_len, dim=1, norm="ortho")


def apply_fresca_to_score(
    score: torch.Tensor,
    low_scale: Scale = 1.0,
    high_scale: Scale = 1.0,
    cutoff_ratio: float = 0.5,
    cutoff_strategy: str = "energy",
    timestep: Optional[torch.Tensor] = None,
    num_steps: Optional[int] = None,
) -> torch.Tensor:
    """FreSca on a score, with the reference's linear decay of a high scale
    above 1: h(t) = (1 − t/num_steps)·(h − 1) + 1.  The sampler hands it the
    continuous t in (0, 1], so the decay is almost nil; that is the JAX
    package's behaviour, kept.  A float scale becomes a device tensor by a
    fill, never by a copy from the host."""
    if isinstance(high_scale, torch.Tensor):
        high = high_scale.to(device=score.device, dtype=score.dtype)
    else:
        high = torch.full((), high_scale, dtype=score.dtype, device=score.device)
    if timestep is not None and num_steps is not None and num_steps > 0:
        t_norm = timestep.to(score.dtype) / num_steps
        decayed = (1.0 - t_norm) * (high - 1.0) + 1.0
        high = torch.where(high > 1.0, decayed, high)
    return frequency_scale(score, low_scale, high, cutoff_ratio, cutoff_strategy)


def analyze_frequency_content(
    x: torch.Tensor, cutoff_ratio: float = 0.5
) -> dict[str, torch.Tensor]:
    """Energy of ``x``'s rfft magnitudes below and above the spatial cutoff."""
    mag = torch.abs(torch.fft.rfft(x, dim=1, norm="ortho"))
    low, high = create_frequency_masks(x.shape[1] // 2 + 1, cutoff_ratio, "spatial",
                                       device=x.device)
    low_energy = (mag * low[None, :, None]).sum()
    high_energy = (mag * high[None, :, None]).sum()
    total = mag.sum()
    return {
        "low_energy": low_energy,
        "high_energy": high_energy,
        "total_energy": total,
        "low_energy_ratio": low_energy / (total + 1e-8),
        "high_energy_ratio": high_energy / (total + 1e-8),
    }
