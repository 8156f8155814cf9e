"""The window's DiT network work over its wall and the float32 peak, in %:
the full forwards the chain ran (the cache statistics' count) times a
forward's FLOPs at the cell's batch and shapes (``flops/dit.py``); a skipped
step runs no network and counts 0."""

from portbench.flops.dit import model_forward_flops
from portbench.flops.peaks import PEAK_FP32_FLOPS


def read(obs):
    w = obs["window"]
    if not w.get("wall_s"):
        return None
    flops = w["full_steps"] * model_forward_flops(obs["config"]["model"], w["rows"])
    return 100.0 * flops / w["wall_s"] / PEAK_FP32_FLOPS
