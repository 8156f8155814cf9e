"""B2 (``blockdiag_mha_bwd``, full attention backward): its least time at
each launch's shape (``flops/attention.py``) over its device time in the
traced segment, in %."""

from portbench.readers import roofline_pct


def read(obs):
    return roofline_pct(obs, "b2")
