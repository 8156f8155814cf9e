from fdtpu_torch.sampling.calibrate import (
    DEFAULT_LADDER,
    TauArm,
    TauCalibration,
    calibrate_tau_0,
)
from fdtpu_torch.sampling.sampler import DiffusionSampler, sample_chain

__all__ = [
    "DEFAULT_LADDER",
    "DiffusionSampler",
    "TauArm",
    "TauCalibration",
    "calibrate_tau_0",
    "sample_chain",
]
