from fdtpu_torch.ops.fourier import (
    dft,
    frequency_decompose_dct,
    frequency_decompose_fft,
    hermite_design_matrix,
    hermite_polynomials,
    idft,
    n_real_components,
    packed_freq_index,
    predict_hermite,
    spectral_density,
)
from fdtpu_torch.ops.fresca import (
    analyze_frequency_content,
    apply_fresca_to_score,
    create_frequency_masks,
    create_frequency_masks_2d,
    frequency_scale,
)

__all__ = [
    "analyze_frequency_content",
    "apply_fresca_to_score",
    "create_frequency_masks",
    "create_frequency_masks_2d",
    "dft",
    "frequency_decompose_dct",
    "frequency_decompose_fft",
    "frequency_scale",
    "hermite_design_matrix",
    "hermite_polynomials",
    "idft",
    "n_real_components",
    "packed_freq_index",
    "predict_hermite",
    "spectral_density",
]
