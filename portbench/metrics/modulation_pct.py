"""The device time of the kernels launched inside the DiT blocks'
``fdtpu.dit.modulation`` ranges (SiLU and Linear(D, 6D), both LayerNorms,
modulate, gates and residuals) over the traced forwards' busy time, in %
(``portbench/ranges.py``)."""

from portbench.ranges import range_pct


def read(obs):
    return range_pct(obs, "fdtpu.dit.modulation")
