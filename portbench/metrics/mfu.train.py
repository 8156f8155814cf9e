"""The fit's network work over its wall and the float32 peak, in %: three
forwards' FLOPs for every training row of every epoch, and one for every
validation row (``flops/transformer.py``)."""

from portbench.flops.peaks import PEAK_FP32_FLOPS
from portbench.flops.transformer import model_forward_flops


def read(obs):
    w = obs["window"]
    if not w.get("wall_s"):
        return None
    model = obs["config"]["model"]
    flops = 3 * model_forward_flops(model, w["rows"]) + model_forward_flops(model, w["val_rows"])
    return 100.0 * flops / w["wall_s"] / PEAK_FP32_FLOPS
