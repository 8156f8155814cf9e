from fdtpu_torch.data.datamodules import (
    DATAMODULE_REGISTRY,
    Datamodule,
    ECGDatamodule,
    MIMICIIIDatamodule,
    NASADatamodule,
    NASDAQDatamodule,
    SyntheticDatamodule,
    USDroughtsDatamodule,
)
from fdtpu_torch.data.dataset import DiffusionDataset, NumpyLoader

__all__ = [
    "DATAMODULE_REGISTRY",
    "Datamodule",
    "DiffusionDataset",
    "ECGDatamodule",
    "MIMICIIIDatamodule",
    "NASADatamodule",
    "NASDAQDatamodule",
    "NumpyLoader",
    "SyntheticDatamodule",
    "USDroughtsDatamodule",
]
