"""The port's span and counter recorder (``fdtpu_torch/utils/profiling.py``)
and the spans and counters of the sampler, the resident chain and the
trainer, on the CPU.  The device intervals are tested with a stand-in for
``torch.cuda.Event``; on the card, ``tests/test_torch_cuda.py``."""

import json
import time
import types

import pytest
import torch

from fdtpu_torch.diffusion import VPScheduler
from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
from fdtpu_torch.sampling import DiffusionSampler
from fdtpu_torch.utils import conditional, profiling
from fdtpu_torch.utils.profiling import count, export, recording, span

TINY = dict(n_channels=1, max_len=16, d_model=12, num_layers=2, n_head=2, dim_feedforward=24)
SCORE = {"level": "score", "R": 3, "tau_0": 0.05, "eps_order": 1}


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def _children(spans, parent):
    return [s["name"] for s in spans if s["parent"] == parent["id"]]


@pytest.fixture
def clock(monkeypatch):
    """A host clock that advances 10 ns at every reading."""
    ticks = iter(range(0, 10**9, 10))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))


# -------------------------------------------------------------- the recorder
def test_spans_nest_with_ids_parents_and_one_call_id_a_root():
    with recording():
        with span("root", level="score"):
            with span("a"):
                with span("a.inner"):
                    pass
            with span("b"):
                pass
        with span("root"):
            pass
    spans = export()["spans"]
    assert [(s["name"], s["id"], s["parent"], s["call"]) for s in spans] == [
        ("root", 0, None, 0), ("a", 1, 0, 0), ("a.inner", 2, 1, 0), ("b", 3, 0, 0),
        ("root", 4, None, 1)]
    assert spans[0]["attrs"] == {"level": "score"}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
    assert spans[0]["start_ns"] <= spans[1]["start_ns"] <= spans[1]["end_ns"] <= \
        spans[3]["start_ns"] <= spans[3]["end_ns"] <= spans[0]["end_ns"]


def test_self_time_is_the_span_less_its_children(clock):
    with recording():  # the base reads 0
        with span("root"):  # 10 .. 80
            with span("a"):  # 20 .. 50
                with span("a.inner"):  # 30 .. 40
                    pass
            with span("b"):  # 60 .. 70
                pass
    spans = {s["name"]: s for s in export()["spans"]}
    assert spans["root"]["end_ns"] - spans["root"]["start_ns"] == 70
    assert {k: s["self_ns"] for k, s in spans.items()} == {
        "root": 70 - 30 - 10, "a": 30 - 10, "a.inner": 10, "b": 10}


def test_counters_add_within_a_recording_only():
    count("x", 5)  # recording off: nothing
    with recording():
        count("x", 2)
        with span("root"):
            count("x", 3)
            count("y", 1)
    count("x", 7)
    assert export()["counters"] == {"x": 5, "y": 1}


def test_span_with_recording_off_is_the_shared_no_op():
    with recording():
        with span("kept"):
            pass
    before = export()
    assert not torch.autograd._profiler_enabled()
    assert span("fdtpu.sample") is profiling.NO_SPAN
    assert span("fdtpu.fit.steps", device=True, epoch=3) is profiling.NO_SPAN
    with span("fdtpu.sample"):
        count("chain.steps", 10)
    assert export() == before


def test_export_is_plain_json():
    with recording():
        with span("root", device=True, steps=1000, level=None):
            count("chain.kernels", 7)
    out = export()
    assert set(out) == {"spans", "counters"}
    (s,) = out["spans"]
    assert set(s) == {"name", "id", "parent", "call", "start_ns", "end_ns", "self_ns",
                      "device_start_ns", "device_end_ns", "attrs"}
    assert s["device_start_ns"] is None and s["device_end_ns"] is None  # no card
    assert json.loads(json.dumps(out)) == out
    with pytest.raises(RuntimeError, match="already open"):
        with recording():
            with recording():
                pass


class FakeEvent:
    """``torch.cuda.Event`` on a made-up device clock: 1 ms a recorded
    event; ``query`` true once ``passed`` (at recording: ``passes``)."""

    made, tick, passes = [], 0, True

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t, self.passed = None, True
        FakeEvent.made.append(self)

    def record(self):
        FakeEvent.tick += 1
        self.t, self.passed = FakeEvent.tick, FakeEvent.passes

    def query(self):
        return self.passed

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def fake_card(monkeypatch):
    FakeEvent.made, FakeEvent.tick, FakeEvent.passes = [], 0, True
    synced = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: synced.append(1))
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    return synced


@pytest.mark.parametrize("capturing", [False, True])
def test_no_event_is_recorded_while_the_stream_captures(fake_card, monkeypatch, capturing):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    with recording() as rec:
        base = rec.base_ns
        with span("root"):
            with span("replay", device=True):
                pass
            with span("host"):
                pass
    spans = {s["name"]: s for s in export()["spans"]}
    assert spans["root"]["device_start_ns"] is None and spans["host"]["device_end_ns"] is None
    if capturing:
        assert len(FakeEvent.made) == 1  # the base alone
        assert spans["replay"]["device_start_ns"] is None
    else:
        # The base at tick 1, the replay's events at ticks 2 and 3: 1 ms apart.
        assert spans["replay"]["device_start_ns"] == base + 1_000_000
        assert spans["replay"]["device_end_ns"] == base + 2_000_000


def test_device_intervals_are_read_when_passed_with_no_added_synchronize(fake_card):
    """Events are read at a root's end or a ``settle`` once the device has
    passed them, with no wait of the recorder's own until the recording
    ends; the events read are reused."""
    with recording() as rec:
        assert fake_card == [1]  # the base, after a synchronise
        FakeEvent.passes = False
        with span("root"):
            with span("replay", device=True):
                pass
        assert len(rec.pending) == 1 and rec.spans[1]["device_end_ns"] is None
        profiling.settle()
        assert len(rec.pending) == 1
        for event in FakeEvent.made:
            event.passed = True
        profiling.settle()
        assert rec.pending == [] and rec.spans[1]["device_end_ns"] is not None
        FakeEvent.passes = True
        with span("root"):
            with span("replay", device=True):
                pass
        assert rec.pending == [] and len(FakeEvent.made) == 3  # two reused
        FakeEvent.passes = False
        with span("late", device=True):
            pass
        assert len(rec.pending) == 1 and fake_card == [1]
    assert fake_card == [1, 1] and rec.pending == []
    assert export()["spans"][-1]["device_end_ns"] is not None


def test_spans_are_profiler_ranges_with_recording_off():
    """Under ``torch.profiler`` each span opens a ``record_function`` range,
    also one that the profiler starts or stops inside."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with span("fdtpu.outer"):  # opened before the profiler: no range
        prof.start()
        with span("fdtpu.inner"):
            torch.ones(3).sum()
        with span("fdtpu.stops"):
            prof.stop()
    names = {e.name for e in prof.events()}
    assert "fdtpu.inner" in names and "fdtpu.outer" not in names


@pytest.mark.parametrize("blocked_by", [None, "capture", "compile"])
def test_profiler_ranges_open_only_under_the_profiler_outside_capture_and_tracing(
        monkeypatch, blocked_by):
    """``profiler_range`` (the DiT block's ``fdtpu.dit.*``): a profiler range
    while the profiler runs, the shared no-op while a stream captures or
    ``torch.compile`` traces, and never a span of a recording."""
    assert profiling.profiler_range("fdtpu.dit.mlp") is profiling._NO_RANGE
    with recording():
        if blocked_by == "capture":
            monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
            monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        elif blocked_by == "compile":
            monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with profiling.profiler_range("fdtpu.dit.mlp"):
                torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert ("fdtpu.dit.mlp" in names) == (blocked_by is None)
    assert export()["spans"] == []


def test_loop_graph_counts_kernel_nodes_by_segment_runs():
    """A trajectory graph's kernel nodes, the last of its counts: the
    prologue's a replay, the WHILE body's (pre, post, setters) a step, each
    IF branch's a run; without a pre segment the one branch runs every
    step."""
    seg = lambda n: types.SimpleNamespace(launched=(0, 0, 0, 0, n))  # noqa: E731
    loop = types.SimpleNamespace(prologue_launched=(0, 0, 0, 0, 1), setters=(0, 0, 0, 0, 2),
                                 pre=seg(16), post=seg(36),
                                 branches=[seg(28), seg(430), seg(431)])
    got = conditional.LoopGraph.launches(loop, 2, 100, [90, 9, 1])
    assert got == (0, 0, 0, 0, 2 + 100 * (2 + 16 + 36) + 90 * 28 + 9 * 430 + 431)
    loop.pre, loop.setters = None, (0, 0, 0, 0, 1)
    got = conditional.LoopGraph.launches(loop, 2, 100, [100])
    assert got == (0, 0, 0, 0, 2 + 100 * (1 + 36 + 28))


def test_kernel_nodes_the_runtime_cannot_count_warn_and_go_uncounted(tiny_model):
    """Counting a graph's kernel nodes never fails a capture: an error gives
    None and a warning, and a chain whose graph went uncounted reads no
    ``chain.kernels``."""
    lib = types.SimpleNamespace(fdtpu_cond_count_kernels=lambda graph, stream, out: 999,
                                fdtpu_cond_error_string=lambda err: b"unknown error")
    with pytest.warns(RuntimeWarning, match="unknown error"):
        assert conditional._kernel_nodes(lib, 1234) is None
    sampler = DiffusionSampler(tiny_model, 4, use_cache=True, cache_kwargs=SCORE,
                               batches_per_call=2)
    sampler.sample(8, 6, generator=torch.Generator().manual_seed(1))
    (chain,) = sampler._chains.values()
    chain.loop = types.SimpleNamespace(launches=lambda *a: (0, 0, 0, 0, 77), counted=False)
    chain.replays = 1
    with recording():
        chain.read()
    assert export()["counters"] == {"chain.steps": 6, "chain.runs.skip": 0,
                                    "chain.runs.refresh": 0, "chain.runs.cold_refresh": 0}


# ------------------------------------------------------ the program's spans
@pytest.fixture(scope="module")
def tiny_model():
    cfg = ScoreModelConfig(**TINY)
    net = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    sched = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(16, "cpu")
    return ScoreModel(cfg, net, sched)


@pytest.mark.parametrize("use_cache, per_call", [(False, 2), (True, 2), (True, 1)],
                         ids=["uncached", "score", "score-eager"])
def test_a_sampler_call_records_its_phases(tiny_model, use_cache, per_call):
    """``sample(8)`` in batches of 4: load, replay (the resident path's) and
    gather a batch, then one read and the finish, under one root; the chain's
    counters (every step one branch's run), none on the eager path."""
    sampler = DiffusionSampler(tiny_model, 4, use_cache=use_cache,
                               cache_kwargs=SCORE if use_cache else None,
                               batches_per_call=per_call)
    with recording():
        sampler.sample(8, 6, generator=torch.Generator().manual_seed(1))
        sampler.sample(8, 6, generator=torch.Generator().manual_seed(2))
    out = export()
    spans, counters = out["spans"], out["counters"]
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["fdtpu.sample"] * 2
    assert roots[0]["attrs"] == {"level": "score" if use_cache else None, "batches": 2,
                                 "steps": 6}
    assert {s["call"] for s in spans} == {0, 1}
    if per_call == 1:
        assert _children(spans, roots[0]) == [
            "fdtpu.sample.load", "fdtpu.sample.gather", "fdtpu.sample.load",
            "fdtpu.sample.gather", "fdtpu.sample.read", "fdtpu.sample.finish"]
        assert counters == {}
        return
    assert _children(spans, roots[0]) == [
        "fdtpu.sample.load", "fdtpu.sample.replay", "fdtpu.sample.gather",
        "fdtpu.sample.load", "fdtpu.sample.replay", "fdtpu.sample.gather",
        "fdtpu.sample.read", "fdtpu.sample.finish"]
    runs = {k: v for k, v in counters.items() if k.startswith("chain.runs.")}
    assert counters["chain.steps"] == 4 * 6
    assert sum(runs.values()) == counters["chain.steps"]
    if use_cache:
        assert set(runs) == {"chain.runs.skip", "chain.runs.refresh", "chain.runs.cold_refresh"}
    else:
        assert runs == {"chain.runs.forward": 24}
    assert "chain.kernels" not in counters  # counted from a captured graph, on a card


class KeepEpoch:
    def on_train_epoch_end(self, trainer, network, epoch):
        pass


@pytest.mark.parametrize("steps_per_call", [1, 16], ids=["eager", "graphed"])
def test_a_fit_records_its_epochs(tmp_path, tiny_model, steps_per_call):
    """A two-epoch fit: one root, two epochs, each with its batches, its
    chunks and steps, the loss read and the epoch end: one validation, one
    resume snapshot and the callbacks, a checkpoint where the val loss
    improved.  No counters."""
    from fdtpu_torch.data import SyntheticDatamodule
    from fdtpu_torch.train import Trainer, get_training_params

    dm = SyntheticDatamodule(tmp_path / "data", max_len=16, num_samples=60, batch_size=16,
                             fourier_transform=True, standardize=True)
    dm.prepare_data()
    dm.setup()
    sizes = [len(b) for b in dm.train_dataloader()]
    groups = 1 + (sizes[-1] != sizes[0]) if steps_per_call > 1 else len(sizes)
    model = ScoreModel(tiny_model.config, tiny_model.network, tiny_model.scheduler,
                       num_training_steps=get_training_params(dm, 2)["num_training_steps"])
    trainer = Trainer(max_epochs=2, run_dir=tmp_path / "runs", run_id="r", seed=1,
                      steps_per_call=steps_per_call, callbacks=[KeepEpoch()])
    with recording():
        trainer.fit(model, dm)
    out = export()
    spans, counters = out["spans"], out["counters"]
    named = _by_name(spans)
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "fdtpu.fit" and root["attrs"] == {"epochs": 2}
    epochs = named["fdtpu.fit.epoch"]
    assert [e["attrs"]["epoch"] for e in epochs] == [0, 1]
    assert all(e["parent"] == root["id"] for e in epochs)
    for e in epochs:
        inner = _children(spans, e)
        assert inner == (["fdtpu.fit.batches"] + ["fdtpu.fit.chunk", "fdtpu.fit.steps"] * groups
                         + ["fdtpu.fit.train_loss", "fdtpu.fit.epoch_end"])
    ends = named["fdtpu.fit.epoch_end"]
    assert [s["attrs"]["epoch"] for s in ends] == [0, 1]
    for end in ends:
        inner = _children(spans, end)
        assert inner[0] == "fdtpu.fit.validation" and inner.count("fdtpu.fit.validation") == 1
        assert inner[-2:] == ["fdtpu.fit.resume_state", "fdtpu.fit.callbacks"]
        assert inner.count("fdtpu.fit.checkpoint") <= 1
    assert _children(spans, ends[0]).count("fdtpu.fit.checkpoint") == 1
    assert len(named["fdtpu.fit.checkpoint"]) == sum(
        1 for e in ends if "fdtpu.fit.checkpoint" in _children(spans, e))
    assert counters == {}
