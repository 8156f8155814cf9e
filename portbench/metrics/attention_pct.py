"""The device time of the kernels launched inside the DiT blocks'
``fdtpu.dit.attention`` ranges (qkv, scores, softmax, values, proj) over
the traced forwards' busy time, in % (``portbench/ranges.py``)."""

from portbench.ranges import range_pct


def read(obs):
    return range_pct(obs, "fdtpu.dit.attention")
