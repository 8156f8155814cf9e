"""B1 (``blockdiag_mha``, full attention forward): its least time at each
launch's shape (``flops/attention.py``) over its device time in the traced
segment, in %."""

from portbench.readers import roofline_pct


def read(obs):
    return roofline_pct(obs, "b1")
