"""The readers of the program's spans and counters (``metrics/chain_ms.py``,
``step_kernels.py``, ``epoch_end_pct.py``) on made-up recordings, and their
silence where a run recorded nothing."""

import pytest

from portbench import common


def span(i, name, parent, start, end, dev=None, call=0):
    return {"name": name, "id": i, "parent": parent, "call": call, "start_ns": start,
            "end_ns": end, "self_ns": None, "device_start_ns": dev and dev[0],
            "device_end_ns": dev and dev[1], "attrs": {}}


def observed(spans=(), counters=None):
    return {"spans": {"spans": list(spans), "counters": counters or {}}}


@pytest.mark.parametrize("metric,file", [
    ("chain_ms.sample", "chain_ms.py"), ("chain_ms.uncached", "chain_ms.py"),
    ("step_kernels.sample", "step_kernels.py"), ("step_kernels.uncached", "step_kernels.py"),
    ("epoch_end_pct.train", "epoch_end_pct.py"),
])
def test_each_metric_has_a_reader_silent_without_spans(metric, file):
    reader = common.load_reader(metric)
    assert reader.__file__.endswith(f"metrics/{file}")
    assert reader.read({}) is None  # a tree without the recorder
    assert reader.read(observed()) is None


def test_chain_ms_is_the_mean_replay_on_the_device():
    spans = [span(0, "fdtpu.sample", None, 0, 10**9),
             span(1, "fdtpu.sample.replay", 0, 10, 20, dev=(100, 280_000_100)),
             span(2, "fdtpu.sample.replay", 0, 30, 40, dev=(300_000_000, 590_000_000)),
             span(3, "fdtpu.sample.replay", 0, 50, 60),  # not read back: left out
             span(4, "fdtpu.sample.read", 0, 70, 80, dev=(0, 10**9))]
    assert common.load_reader("chain_ms.sample").read(observed(spans)) == pytest.approx(285.0)


def test_step_kernels_are_kernels_over_steps():
    counters = {"chain.steps": 4000, "chain.kernels": 330_004,
                "chain.runs.skip": 3930}
    assert common.load_reader("step_kernels.sample").read(
        observed(counters=counters)) == pytest.approx(82.501)
    assert common.load_reader("step_kernels.sample").read(
        observed(counters={"chain.steps": 4000})) is None


def test_epoch_end_pct_is_the_epoch_ends_less_callbacks_over_the_fit():
    spans = [span(0, "fdtpu.fit", None, 0, 20_000, call=0),  # another fit: not read
             span(1, "fdtpu.fit.epoch_end", 0, 0, 10_000, call=0),
             span(2, "fdtpu.fit", None, 100_000, 200_000, call=1),
             span(3, "fdtpu.fit.epoch", 2, 100_000, 150_000, call=1),
             span(4, "fdtpu.fit.train_loss", 3, 120_000, 130_000, call=1),
             span(5, "fdtpu.fit.epoch_end", 3, 130_000, 149_000, call=1),
             span(6, "fdtpu.fit.validation", 5, 130_000, 134_000, call=1),
             span(7, "fdtpu.fit.checkpoint", 5, 134_000, 135_000, call=1),
             span(8, "fdtpu.fit.resume_state", 5, 135_000, 138_000, call=1),
             span(9, "fdtpu.fit.callbacks", 5, 138_000, 147_000, call=1),
             span(10, "fdtpu.fit.callbacks", 3, 149_000, 150_000, call=1),  # not in an end
             span(11, "fdtpu.fit.epoch_end", 2, 180_000, 182_000, call=1)]
    assert common.load_reader("epoch_end_pct.train").read(observed(spans)) == \
        pytest.approx(100.0 * (19_000 - 9_000 + 2_000) / 100_000)
