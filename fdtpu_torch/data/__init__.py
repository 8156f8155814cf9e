from fdtpu_torch.data.datamodules import SyntheticDatamodule
from fdtpu_torch.data.dataset import DiffusionDataset, NumpyLoader

__all__ = ["DiffusionDataset", "NumpyLoader", "SyntheticDatamodule"]
