from fdtpu_torch.sampling.sampler import DiffusionSampler, sample_chain

__all__ = ["DiffusionSampler", "sample_chain"]
