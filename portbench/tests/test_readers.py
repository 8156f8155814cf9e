"""The per-layer readers on made-up observations: which file reads a
metric, and the arithmetic of the trace readers."""

import pytest

from portbench import common
from portbench.flops.attention import attention_bound_s, attention_bwd_bound_s

B1, B2 = "blockdiag_mha_fwd_kernel", "blockdiag_mha_bwd_kernel"


def observed(kernels, **traced):
    """``obs`` as ``run.py`` hands it to a reader: the trace's kernels as
    [count, seconds, first start, last end], and the traced segment's facts."""
    return {"trace": {"kernels": kernels, "busy_s": 1.5, "window_s": 2.0}, "traced": traced}


@pytest.mark.parametrize("metric,file", [
    ("mfu.uncached", "mfu.py"), ("mfu.train", "mfu.train.py"),
    ("b1_roofline.train", "b1_roofline.py"), ("step_ms.train", "step_ms.train.py"),
])
def test_a_metric_is_read_by_its_own_file_or_its_base(metric, file):
    assert common.load_reader(metric).__file__.endswith(f"metrics/{file}")


def test_a_metric_without_a_reader_is_refused():
    with pytest.raises(common.BenchError):
        common.load_reader("no_such_metric.sample")


def test_step_ms_spans_first_b1_to_last_b2():
    obs = observed({f"void {B1}<64>": [400, 0.2, 0.010, 1.95],
                    f"void {B2}<64>": [400, 0.3, 0.030, 1.77],
                    "sgemm": [900, 1.0, 0.001, 1.99]}, steps=40)
    assert common.load_reader("step_ms.train").read(obs) == pytest.approx(1e3 * 1.76 / 40)


def test_step_ms_is_silent_without_both_kernels():
    obs = observed({f"void {B1}<64>": [400, 0.2, 0.010, 1.95]}, steps=40)
    assert common.load_reader("step_ms.train").read(obs) is None


def test_rooflines_and_idle_share():
    shapes = {"b1": [(64, 365, 12, 6, 10)], "b2": [(64, 365, 12, 6, 10)]}
    obs = observed({B1: [10, 0.01, 0.0, 1.0], B2: [10, 0.02, 0.0, 1.0]}, shapes=shapes)
    want_b1 = 100 * 10 * attention_bound_s(64, 365, 12, 6)[0] / 0.01
    want_b2 = 100 * 10 * attention_bwd_bound_s(64, 365, 12, 6)[0] / 0.02
    assert common.load_reader("b1_roofline.train").read(obs) == pytest.approx(want_b1)
    assert common.load_reader("b2_roofline.train").read(obs) == pytest.approx(want_b2)
    assert common.load_reader("idle_pct.train").read(obs) == pytest.approx(25.0)
