"""The traced segment's wall in which no operation ran on the device, in %."""

from portbench.readers import idle_pct


def read(obs):
    return idle_pct(obs)
