"""Grouped sampling (``DiffusionSampler(batches_per_call > 1)``) and the
graph runner of the trainer's step graphs, on the CPU.

On a CPU network the grouped path runs the resident chain's functions
(``fdtpu_torch/sampling/resident.py``: static buffers, device counters and
decisions, write-back, the prologue's draws) as a loop, so these tests hold
that code against the JAX package's resident path
(``_sample_batches_resident``) with the JAX draws handed to the port: per
batch ``key, k_prior, k_chain = split(key, 3)``, per step ``k, k_noise =
split(k)`` (uncached and score level) or ``k, k_noise, k_probe = split(k,
3)`` (token and KV level), as tests/test_torch_sampling.py and
tests/test_torch_token_kv.py replay them.  Tolerances are
tests/test_resident_sampling.py's: samples rtol 2e-5 / atol 5e-5, cache
statistics rel 1e-5.  Against the port's own eager loop the values must be
equal.  The launch accounting of the trainer's captured step graphs is held
with a fake graph class; the card tests (tests/test_torch_cuda.py) hold
real graphs, the resident chain's conditional nodes included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.diffusion import VPScheduler as JaxVP
from fdtpu.models import score_models as jsm
from fdtpu.sampling import sampler as jsampler
from fdtpu_torch.diffusion import VPScheduler
from fdtpu_torch.kernels import attention as mha
from fdtpu_torch.kernels import blockdiag_attention as bda
from fdtpu_torch.models import score_models as psm
from fdtpu_torch.sampling import DiffusionSampler, calibrate_tau_0
from fdtpu_torch.utils import graphs
from fdtpu_torch.utils.convert import load_jax_variables

T, C, B = 17, 2, 4
# A width of its own (FFN 28): no other test compiles a JAX chain of this model.
SMALL = dict(n_channels=C, max_len=T, d_model=12, num_layers=2, n_head=2, dim_feedforward=28)
BETA_MAX = 2.0


@pytest.fixture(scope="module")
def models():
    jcfg = jsm.ScoreModelConfig(**SMALL)
    variables = jsm.init_score_model(jax.random.PRNGKey(0), jcfg)
    net = psm.init_score_model(psm.ScoreModelConfig(**SMALL), device="cpu")
    load_jax_variables(net, jax.tree.map(np.asarray, variables))
    js = JaxVP(fourier_noise_scaling=True, beta_max=BETA_MAX).with_noise_scaling(T)
    ps = VPScheduler(fourier_noise_scaling=True, beta_max=BETA_MAX).with_noise_scaling(T, "cpu")
    return (jsm.ScoreModel(config=jcfg, variables=variables, scheduler=js),
            psm.ScoreModel(config=net.config, network=net, scheduler=ps))


def sampler_draws(seed, num_batches, n, probes):
    """Prior, step and (``probes``: token and KV level) probe draws of the
    JAX DiffusionSampler, per batch in the host loop's order."""
    key = jax.random.PRNGKey(seed)
    prior, steps, uniforms = [], [], []
    for _ in range(num_batches):
        key, k_prior, k_chain = jax.random.split(key, 3)
        prior.append(np.array(jax.random.normal(k_prior, (B, T, C))))
        zs, us = [], []
        for _ in range(n):
            if probes:
                k_chain, k_noise, k_probe = jax.random.split(k_chain, 3)
                us.append(np.array(jax.random.uniform(k_probe, (T,))))
            else:
                k_chain, k_noise = jax.random.split(k_chain)
            zs.append(np.array(jax.random.normal(k_noise, (B, T, C), jnp.float32)))
        steps.append(np.stack(zs))
        uniforms.append(np.stack(us) if probes else np.zeros((n, T), np.float32))
    return (torch.from_numpy(np.concatenate(prior)), torch.from_numpy(np.concatenate(steps, 1)),
            torch.from_numpy(np.stack(uniforms)))


def _stats_agree(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


CASES = {
    # name: (cache_kwargs or None, batches, batches_per_call, steps, extra sampler kwargs)
    "uncached-boundary": (None, 5, 2, 8, {}),
    "score": (dict(level="score", R=3, tau_0=0.05), 4, 4, 10, {}),
    "score-reset-remainder": (dict(level="score", R=3, tau_0=0.05, reset_between_batches=True),
                              3, 2, 10, {}),
    "score-freqca-fresca": (dict(level="score", R=6, tau_0=0.6, eps_predictor="freqca",
                                 max_history=4, hermite_order=2, guard="off"), 2, 2, 14,
                            dict(use_fresca=True, fresca_high_scale=1.3)),
    "token": (dict(level="token", token_budget=4, tau_0=5.0, R=12, random_probe_ratio=0.2,
                   guard="off"), 4, 2, 16, {}),
    "kv-event-freqca": (dict(level="kv", policy="event", K=1, R=6, tau_0=1.0, tau_warn=1e9,
                             random_probe_ratio=0.1, use_freqca=True, freq_decomp_interval=4),
                        3, 3, 12, {}),
    # 4 batches of 30 steps: the macro policy's MIXED refresh falls on global step 100.
    "kv-macro": (dict(level="kv", policy="macro", K=2, R=100), 4, 2, 30, {}),
    "single-batch": (dict(level="score", R=3, tau_0=0.05), 1, 4, 8, {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_grouped_sampler_matches_jax(models, name):
    jmodel, pmodel = models
    kw, num_batches, per_call, n, extra = CASES[name]
    cache = dict(use_cache=kw is not None, cache_kwargs=kw or {})
    seed = 17
    jsamp = jsampler.DiffusionSampler(jmodel, B, batches_per_call=per_call, **cache, **extra)
    want = jsamp.sample(num_batches * B, n, key=jax.random.PRNGKey(seed))
    probes = kw is not None and kw["level"] != "score"
    prior, steps, uniforms = sampler_draws(seed, num_batches, n, probes)
    psamp = DiffusionSampler(pmodel, B, batches_per_call=per_call, **cache, **extra)
    got = psamp.sample(num_batches * B, n, prior_noise=prior, step_noise=steps,
                       probe_noise=uniforms if probes else None)
    assert got.shape == want.shape == (num_batches * B, T, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=5e-5)
    if kw is not None:
        stats = psamp.get_cache_stats()
        _stats_agree(stats, jsamp.get_cache_stats())
        if name == "kv-macro":
            assert stats["mixed_steps"] == 1
        if name == "token":
            assert stats["mixed_steps"] and stats["cached_steps"] and stats["full_steps"]
    # One chain, resident only where batches are grouped.
    (chain,) = psamp._chains.values()
    assert chain.resident == (num_batches >= per_call)


@pytest.mark.parametrize("name", ["uncached-boundary", "score", "token", "kv-event-freqca"])
def test_grouped_sampler_equals_the_eager_loop_with_a_generator(models, name):
    """Drawn from the sampler's generator, twice in a row (the second call
    replays the first call's chain): the same samples, statistics and
    generator state as ``batches_per_call=1``."""
    _, pmodel = models
    kw, num_batches, per_call, n, extra = CASES[name]
    cache = dict(use_cache=kw is not None, cache_kwargs=kw or {})
    eager = DiffusionSampler(pmodel, B, **cache, **extra)
    grouped = DiffusionSampler(pmodel, B, batches_per_call=per_call, **cache, **extra)
    for _ in range(2):
        g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
        a = eager.sample(num_batches * B, n, generator=g1)
        b = grouped.sample(num_batches * B, n, generator=g2)
        torch.testing.assert_close(b, a, rtol=0, atol=0)
        assert torch.equal(g1.get_state(), g2.get_state())
        assert eager.get_cache_stats() == grouped.get_cache_stats()
    # Each sampler ran both calls on one chain.
    assert len(grouped._chains) == len(eager._chains) == 1


def test_grouped_sampler_guard_still_fires(models):
    """The collapse guard reads the final state of a grouped run: with a
    zero worst-span tolerance any measured skip span warns, as in
    tests/test_torch_sampling.py."""
    _, pmodel = models
    sampler = DiffusionSampler(pmodel, B, batches_per_call=2, use_cache=True,
                               cache_kwargs=dict(R=8, tau_0=1.35, guard="warn",
                                                 guard_max_tol=0.0))
    with pytest.warns(UserWarning, match="error-budget guard"):
        sampler.sample(2 * B, 30, generator=torch.Generator().manual_seed(2))
    assert sampler.get_cache_stats()["guard_measurements"] > 0


def test_calibration_groups_batches_with_the_same_result(models):
    """``calibrate_tau_0(batches_per_call=2)``: the τ₀, the arms' skip ratios
    and distances of ``batches_per_call=1``."""
    _, pmodel = models
    kw = dict(num_samples=4 * B, num_diffusion_steps=12, sample_batch_size=B, seed=3,
              ladder=(1.5, 0.6, 0.2), num_directions=16, guard_abs_tol=2.5, guard_max_tol=2.0,
              cache_kwargs={"R": 6})
    one = calibrate_tau_0(pmodel, **kw)
    two = calibrate_tau_0(pmodel, batches_per_call=2, **kw)
    assert two == one
    assert any(arm.steps_skipped_ratio > 0 for arm in one.arms)


class FakeGraph:
    """Stands in for a CUDA graph: ``capture`` runs the segment's Python as
    a capture does (the wrappers count), ``replay`` runs nothing."""

    made = []

    def __init__(self, pool, generators):
        self.replays = 0
        FakeGraph.made.append(self)

    @staticmethod
    def warm_up(fn):
        fn()

    def capture(self, fn):
        fn()

    def replay(self):
        self.replays += 1


def _launch(b1=0, b2=0, b3=0, b4=0):
    bda.launches += b1
    bda.launches_bwd += b2
    bda.launches_trainable += b3
    mha.launches += b4


def test_graph_runner_adds_each_capture_s_launches_at_every_replay(monkeypatch):
    for module, name in graphs.COUNTERS:
        monkeypatch.setattr(module, name, 0)
    FakeGraph.made.clear()
    runner = graphs.GraphRunner(FakeGraph)
    runs = []

    def segment():
        runs.append(1)
        _launch(b1=10, b2=3, b3=2, b4=1)

    runner.run("full", segment)  # the warm-up: a real step, counted by the wrappers
    assert graphs.launch_counts() == (10, 3, 2, 1, 0, 0, 0, 0)
    assert len(runs) == 2 and len(FakeGraph.made) == 1  # warm-up, then the capture
    for _ in range(3):
        runner.run("full", segment)
    assert len(runs) == 2 and FakeGraph.made[0].replays == 3 and runner.replays == 3
    assert graphs.launch_counts() == (40, 12, 8, 4, 0, 0, 0, 0)
    runner.run("skip", lambda: _launch(b4=2))
    runner.run("skip", lambda: None)
    assert graphs.launch_counts() == (40, 12, 8, 8, 0, 0, 0, 0)


def test_a_failed_capture_raises_and_leaves_the_counts(monkeypatch):
    for module, name in graphs.COUNTERS:
        monkeypatch.setattr(module, name, 0)

    class Broken(FakeGraph):
        def capture(self, fn):
            fn()
            raise RuntimeError("operation not permitted when stream is capturing")

    runner = graphs.GraphRunner(Broken)
    with pytest.raises(RuntimeError, match="capturing"):
        runner.run("full", lambda: _launch(b1=5))
    assert graphs.launch_counts() == (5, 0, 0, 0, 0, 0, 0, 0) and not runner.graphs


def test_a_cpu_runner_runs_every_segment_directly():
    runner = graphs.GraphRunner.for_device(torch.device("cpu"))
    calls = []
    for _ in range(3):
        runner.run("k", lambda: calls.append(1))
    assert len(calls) == 3 and not runner.captures and not runner.graphs


def test_write_back_clones_a_value_that_aliases_another_static_tensor():
    """``eps_prev`` takes the old ``eps_hat`` while ``eps_hat`` takes a new
    value: the copy must not read the overwritten tensor; a store updated in
    place is left alone; an empty placeholder is fine."""
    hat, prev = torch.tensor([1.0, 2.0]), torch.tensor([5.0, 6.0])
    store, empty = torch.tensor([7.0]), torch.zeros((0,))
    targets = dict(eps_hat=hat, eps_prev=prev, k=store, v=empty)
    graphs.write_back(targets, dict(eps_hat=torch.tensor([3.0, 4.0]), eps_prev=hat, k=store,
                                    v=torch.zeros((0,))))
    assert hat.tolist() == [3.0, 4.0] and prev.tolist() == [1.0, 2.0]
    assert targets["k"] is store and store.tolist() == [7.0]


def test_uncounted_hands_back_the_launches_and_puts_the_counts_back(monkeypatch):
    """The capture helper: the enclosed block's launches come back as a
    list and leave the counters as they were, also when the block raises;
    ``add_counts`` adds a replay's."""
    for module, name in graphs.COUNTERS:
        monkeypatch.setattr(module, name, 0)
    _launch(b1=1)
    with graphs.uncounted() as launched:
        _launch(b1=3, b4=2)
    assert launched == [3, 0, 0, 2, 0, 0, 0, 0]
    assert graphs.launch_counts() == (1, 0, 0, 0, 0, 0, 0, 0)
    with pytest.raises(RuntimeError, match="capture refused"):
        with graphs.uncounted():
            _launch(b2=5)
            raise RuntimeError("capture refused")
    assert graphs.launch_counts() == (1, 0, 0, 0, 0, 0, 0, 0)
    graphs.add_counts(launched)
    assert graphs.launch_counts() == (4, 0, 0, 2, 0, 0, 0, 0)
