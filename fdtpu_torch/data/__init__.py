from fdtpu_torch.data.datamodules import SyntheticDatamodule
from fdtpu_torch.data.dataset import DiffusionDataset

__all__ = ["DiffusionDataset", "SyntheticDatamodule"]
