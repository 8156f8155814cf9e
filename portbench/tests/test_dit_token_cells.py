"""The DiT and token cells' parts on the CPU: their readers on made-up
observations, the DiT operation count against a hand count, the token
level's reference chain against the port, and that their modules load no
JAX."""

import contextlib
import subprocess
import sys
from unittest import mock

import pytest
import torch
from conftest import tiny_cell

from portbench import common, run
from portbench.flops import dit as dit_flops
from portbench.flops.attention import attention_bound_s
from portbench.flops.peaks import PEAK_FP32_FLOPS

DIT = dict(max_len=365, n_channels=13, d_model=1152, num_layers=28, dim_feedforward=4608)


def test_dit_flops_against_a_hand_count():
    # T 4, C 2, D 8, 3 blocks, F 32.  A token, a block: qkv 2·8·24 = 384,
    # scores and values 4·4·8 = 128, proj 2·8·8 = 128, MLP 4·8·32 = 1,024;
    # a sample, a block: modulation 2·8·48 = 768.  Once: embedding 2·4·2·8
    # = 128, time MLP 2·256·8 + 2·8·8 = 4,224, final modulation 2·8·16 = 256
    # and projection 2·4·8·2 = 128.
    want = 3 * (4 * (384 + 128 + 128 + 1024) + 768) + 128 + 4224 + 256 + 128
    assert dit_flops.forward_flops_per_row(4, 2, 8, 3, 32) == want == 27_008
    model = dict(max_len=4, n_channels=2, d_model=8, num_layers=3, dim_feedforward=32)
    assert dit_flops.model_forward_flops(model, 5) == 5 * want


def test_dit_xl_forward_is_0_939_gflop_a_token():
    d, t = 1152, 365
    per_token = 28 * (24 * d * d + 4 * t * d)
    assert per_token == 938_907_648
    row = dit_flops.forward_flops_per_row(t, 13, d, 28, 4 * d)
    extra = row - t * per_token - 28 * 12 * d * d
    assert 0 < extra < 1e-3 * row  # the embedding, time MLP and final layer
    assert dit_flops.model_forward_flops(DIT, 32) == pytest.approx(10.98e12, rel=1e-3)


@pytest.mark.parametrize("metric,file", [
    ("mfu.dit", "mfu.dit.py"), ("attention_pct.dit", "attention_pct.py"),
    ("modulation_pct.dit", "modulation_pct.py"), ("b4_roofline.token", "b4_roofline.py"),
    ("full_forward_pct.dit", "full_forward_pct.py"), ("forward_ms.dit", "forward_ms.py"),
    ("full_forward_pct.token", "full_forward_pct.py"), ("forward_ms.token", "forward_ms.py"),
])
def test_each_metric_has_its_reader(metric, file):
    assert common.load_reader(metric).__file__.endswith(f"metrics/{file}")


def test_mfu_dit_is_full_forwards_over_the_wall_and_peak():
    window = dict(wall_s=50.0, full_steps=120, rows=32, steps=8000)
    got = common.load_reader("mfu.dit").read({"window": window, "config": {"model": DIT}})
    want = 100.0 * 120 * dit_flops.model_forward_flops(DIT, 32) / 50.0 / PEAK_FP32_FLOPS
    assert got == pytest.approx(want)
    assert common.load_reader("mfu.dit").read({"window": dict(window, wall_s=0.0),
                                               "config": {"model": DIT}}) is None


def test_range_shares_are_device_seconds_over_busy_time():
    ranges = {"fdtpu.dit.attention": 0.3, "fdtpu.dit.mlp": 0.9, "fdtpu.dit.modulation": 0.06}
    obs = {"trace": {"kernels": {}, "busy_s": 1.5, "window_s": 2.0},
           "traced": {"forwards": 5, "ranges": ranges}}
    assert common.load_reader("attention_pct.dit").read(obs) == pytest.approx(20.0)
    assert common.load_reader("modulation_pct.dit").read(obs) == pytest.approx(4.0)
    # Silent where nothing was sorted into a range, or there is no device trace.
    for silent in ({"trace": obs["trace"], "traced": {"ranges": {}}},
                   {"traced": {"ranges": ranges}}, {}):
        assert common.load_reader("attention_pct.dit").read(silent) is None


def test_b4_roofline_is_the_bound_over_b4s_device_time():
    shapes = {"b4": [(128, 24, 12, 6, 365, 500)]}
    kernels = {"void fused_mha_f32_kernel<8, 2>(...)": [500, 0.02, 0.0, 1.0],
               "void fused_mha_bf16_kernel<8, 32>(...)": [7, 1.0, 0.0, 1.0],
               "sgemm": [900, 1.0, 0.0, 1.0]}
    obs = {"trace": {"kernels": kernels, "busy_s": 1.5, "window_s": 2.0},
           "traced": {"shapes": shapes}}
    bound, what = attention_bound_s(128, 24, 12, 6, kv_len=365)
    assert what == "bytes"
    assert common.load_reader("b4_roofline.token").read(obs) == pytest.approx(
        100.0 * 500 * bound / 0.02)
    obs["trace"]["kernels"] = {"sgemm": [900, 1.0, 0.0, 1.0]}
    assert common.load_reader("b4_roofline.token").read(obs) is None


@pytest.mark.filterwarnings("ignore:E2-CRF error-budget guard")
@pytest.mark.parametrize("follow", [False, True])
def test_token_reference_chain_against_the_port(follow):
    """Two trajectories of 4 at a tiny width: the reference's own modes and
    rows are the port's, and its samples agree (rtol 1e-4, atol 1e-5, as
    test_reference.py holds the score level's)."""
    from fdtpu_torch.sampling import DiffusionSampler
    from portbench import program, weights
    from portbench.reference import token_chain
    from portbench.reference.model import VP

    model = dict(backbone="transformer", n_channels=2, max_len=20, d_model=12, num_layers=2,
                 n_head=3, dim_feedforward=32, dropout=0.1, gfp_scale=30.0, ln_eps=1e-5,
                 attention_impl="auto", compute_dtype="float32")
    sde = dict(kind="vp", beta_min=0.1, beta_max=20.0, eps=1e-5, fourier_noise_scaling=True)
    cache = {"level": "token", "token_budget": 6, "tau_0": 0.5, "R": 10}
    w = weights.make_weights(model, 5, "cpu")
    steps = 60
    sampler = DiffusionSampler(program.score_model(dict(model=model, sde=sde), w, "cpu", steps),
                               4, use_cache=True, cache_kwargs=cache, batches_per_call=2)
    g = torch.Generator().manual_seed(1)
    prior, noise = torch.randn((8, 20, 2), generator=g), torch.randn((steps, 8, 20, 2),
                                                                     generator=g)
    probes = torch.rand((2, steps, 20), generator=g)
    got = sampler.sample(8, steps, prior_noise=prior, step_noise=noise, probe_noise=probes)
    ref = token_chain.run_call(w, model, VP(sde, 20, "cpu"), prior, noise, probes, 4, cache,
                               sampler.last_modes if follow else None,
                               sampler.last_rows if follow else None, 1e-3)
    torch.testing.assert_close(got, ref["samples"], rtol=1e-4, atol=1e-5)
    assert torch.equal(ref["modes"], sampler.last_modes)
    assert torch.equal(ref["rows"], sampler.last_rows)
    assert ref["mismatched"] == ref["rows_mismatched"] == 0
    assert set(ref["modes"].flatten().tolist()) == {0, 1, 2}


def test_token_reference_counts_a_judged_row_outside_the_band():
    """A judged run whose TOPK rows differ from the reference's where the
    priorities are far apart: each foreign row is a mismatch."""
    from portbench import weights
    from portbench.reference import token_chain
    from portbench.reference.model import VP

    model = dict(n_channels=2, max_len=20, d_model=12, num_layers=2, n_head=3,
                 dim_feedforward=32, gfp_scale=30.0, ln_eps=1e-5)
    sde = dict(beta_min=0.1, beta_max=20.0, eps=1e-5, fourier_noise_scaling=True)
    cache = {"level": "token", "token_budget": 6, "tau_0": 0.5, "R": 10}
    w = weights.make_weights(model, 5, "cpu")
    g = torch.Generator().manual_seed(1)
    prior, noise = torch.randn((4, 20, 2), generator=g), torch.randn((30, 4, 20, 2), generator=g)
    probes = torch.ones((1, 30, 20))  # no probes: the rows are the priorities' alone
    vp = VP(sde, 20, "cpu")
    own = token_chain.run_call(w, model, vp, prior, noise, probes, 4, cache)
    topk = own["modes"] == token_chain.TOPK
    assert bool(topk.any())
    judged = own["rows"].clone()
    step = int(topk[0].nonzero()[0])
    judged[0, step, -1] = 19 if int(judged[0, step, -1]) != 19 else 18
    ref = token_chain.run_call(w, model, vp, prior, noise, probes, 4, cache, own["modes"],
                               judged, 1e-3)
    assert ref["rows_mismatched"] == 1 and ref["mismatched"] == ref["rows_followed"] == 0
    # It went on with its own rows.
    assert torch.equal(ref["samples"], own["samples"])


@contextlib.contextmanager
def _half_batch_where_these_cells_compute():
    """``faults.py``'s ``half_batch`` (the score of the second half of the
    rows zero) planted where these two cells compute, which its patch of
    ``ScoreNetwork.forward`` does not reach: DiT's forward, and the token
    level's full and TOPK forwards."""
    from fdtpu_torch.models import DiTScoreNetwork
    from fdtpu_torch.sampling import sampler

    def half(out):
        n = out.shape[0] // 2
        return torch.cat([out[:n], torch.zeros_like(out[n:])])

    forward, cached, topk = (DiTScoreNetwork.forward, sampler.score_apply_cached,
                             sampler.score_apply_topk)

    def half_forward(self, x, timesteps, train=False, generator=None):
        return half(forward(self, x, timesteps, train, generator))

    def half_cached(*args):
        score, kv, crf = cached(*args)
        return half(score), kv, crf

    def half_topk(*args):
        rows, kv = topk(*args)
        return half(rows), kv

    with mock.patch.object(DiTScoreNetwork, "forward", half_forward), \
            mock.patch.object(sampler, "score_apply_cached", half_cached), \
            mock.patch.object(sampler, "score_apply_topk", half_topk):
        yield


@pytest.mark.filterwarnings("ignore:E2-CRF error-budget guard")
@pytest.mark.parametrize("name", ["dit-xl-droughts365-sample-score", "droughts365-sample-token"])
def test_half_batch_where_the_cell_computes_is_caught(name):
    cell, traffic, config = tiny_cell(name)
    with _half_batch_where_these_cells_compute():
        r = run.run_cell(name, cell, traffic, config, 2**40 + 11, 0.2, False, "cpu",
                         common.manifest())
    assert not r["correct"], r["numbers"]
    assert r["numbers"]["sample_gap"] > traffic["limits"]["sample_gap"]


def test_the_new_cells_load_no_jax():
    code = (
        "import sys, pathlib; sys.path.insert(0, str(pathlib.Path('.').resolve()))\n"
        "import portbench.entries.sample_dit, portbench.entries.sample_token\n"
        "import portbench.reference.dit, portbench.reference.token_chain\n"
        "import portbench.ranges, portbench.weights_dit, portbench.flops.dit\n"
        "from portbench import common\n"
        "import fdtpu_torch.models.dit\n"
        "for m in common.manifest()['per_layer']: common.load_reader(m['name'])\n"
        "print(common.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_device_seconds_sorts_device_operations_by_the_annotation_around_them():
    """Device operations count toward the named device-side annotation that
    holds their midpoint (``portbench/ranges.py``); others toward None,
    annotations themselves never."""
    from types import SimpleNamespace as NS

    from portbench import ranges

    def ev(name, start, end, device=True, note=False):
        return NS(name=name, device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
                  is_user_annotation=note, time_range=NS(start=start, end=end))

    events = [ev("portbench.window", 0, 100, note=True), ev("fdtpu.dit.mlp", 10, 30, note=True),
              ev("fdtpu.dit.attention", 30, 60, note=True), ev("fdtpu.dit.mlp", 10, 30,
                                                               device=False, note=True),
              ev("gemm", 10, 20), ev("gelu", 20, 29), ev("softmax", 31, 59), ev("embed", 2, 8),
              ev("aten::addmm", 11, 12, device=False)]
    got = ranges.device_seconds(NS(events=lambda: events), ["fdtpu.dit.mlp",
                                                            "fdtpu.dit.attention"])
    assert got == pytest.approx({"fdtpu.dit.mlp": 19e-6, "fdtpu.dit.attention": 28e-6,
                                 None: 6e-6})
