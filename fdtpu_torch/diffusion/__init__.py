from fdtpu_torch.diffusion.losses import sde_loss
from fdtpu_torch.diffusion.sde import SDE, VEScheduler, VPScheduler, noise_scaling_vector

__all__ = ["SDE", "VEScheduler", "VPScheduler", "noise_scaling_vector", "sde_loss"]
