from fdtpu_torch.metrics.metrics import (
    MarginalWasserstein,
    Metric,
    MetricCollection,
    SlicedWasserstein,
)
from fdtpu_torch.metrics.wasserstein import WassersteinDistances, wasserstein2_1d

__all__ = [
    "WassersteinDistances",
    "wasserstein2_1d",
    "Metric",
    "MetricCollection",
    "SlicedWasserstein",
    "MarginalWasserstein",
]
