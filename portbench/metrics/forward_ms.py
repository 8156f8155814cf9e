"""One full forward of the score network at the cell's batch and shapes, in
ms: the device's busy time over the traced segment's eager forwards, over
their count."""


def read(obs):
    trace, traced = obs.get("trace"), obs.get("traced") or {}
    if not trace or not traced.get("forwards") or trace["busy_s"] <= 0.0:
        return None
    return 1e3 * trace["busy_s"] / traced["forwards"]
