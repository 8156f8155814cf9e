from fdtpu_torch.diffusion.sde import SDE, VEScheduler, VPScheduler, noise_scaling_vector

__all__ = ["SDE", "VEScheduler", "VPScheduler", "noise_scaling_vector"]
