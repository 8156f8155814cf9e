"""One optimizer step of the fit, in ms, on the device's timeline: the traced
epoch's span from the start of its first B1 launch (the first step's
attention) to the end of its last B2 launch (the last step's attention
backward), over the epoch's steps.  The span holds the steps' replays and
the host's gaps between chunks; it leaves out the first step's embedding and
the last step's clip and AdamW, under a millisecond of the epoch."""

from portbench.readers import extent


def read(obs):
    b1, b2 = extent(obs, "b1"), extent(obs, "b2")
    steps = (obs.get("traced") or {}).get("steps")
    if b1 is None or b2 is None or not steps or b2[1] <= b1[0]:
        return None
    return 1e3 * (b2[1] - b1[0]) / steps
