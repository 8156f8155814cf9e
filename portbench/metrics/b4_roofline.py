"""B4 (``fused_mha``, float32, queries against the stored keys): its least
time at each launch's shape (``flops/attention.py``, with the keys'
length) over its device time in the traced segment, in %."""

from portbench.flops.attention import attention_bound_s
from portbench.trace import count

KERNEL = "fused_mha_f32_kernel"


def read(obs):
    trace = obs.get("trace")
    shapes = (obs.get("traced") or {}).get("shapes", {}).get("b4")
    if not trace or not shapes:
        return None
    n, seconds = count(trace["kernels"], KERNEL)
    if n == 0 or seconds <= 0.0:
        return None
    least = sum(attention_bound_s(b, tq, h, dh, kv_len=tk)[0] * launches
                for b, tq, h, dh, tk, launches in shapes)
    return 100.0 * least / seconds
