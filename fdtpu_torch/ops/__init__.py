from fdtpu_torch.ops.fourier import dft, idft, n_real_components, packed_freq_index

__all__ = ["dft", "idft", "n_real_components", "packed_freq_index"]
