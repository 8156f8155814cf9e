"""The resident reverse chain on the CPU (``fdtpu_torch/sampling/resident.py``)
and the tensor form of the E²-CRF decisions it takes on the device.

On a CPU network ``DiffusionSampler(batches_per_call=k > 1)`` runs the
resident chain's functions as a loop: the prologue draws the whole
trajectory's noise, then each step's decision is read from the same device
tensor the card's conditional nodes read.  These tests hold it against the
JAX package's ``_sample_batches_resident`` (``DiffusionSampler(
batches_per_call=k)``, k = 2 and 3, with a remainder batch, which the JAX
package sends through its per-batch program and the port replays through
the same graph) at every level, with the JAX draws handed in (per batch
``key, k_prior, k_chain = split(key, 3)``, per step ``k, k_noise =
split(k)`` or ``k, k_noise, k_probe = split(k, 3)`` at the token and KV
levels): samples at rtol 2e-5 / atol 5e-5, FreqCa's ring timesteps at atol
6e-8 (XLA's CPU ``linspace`` may round one float32 ulp apart), cache
statistics at rel 1e-5 (counts exactly); and against the port's eager loop:
the same mode at every step and the same statistics, exactly.

The decisions (:func:`score_skip_decision`, :func:`token_policy`,
:func:`event_policy`, :func:`macro_policy`, :func:`kv_ring_due`) and the
counters' update (:func:`count_mode`) take the counters as 0-d int64
tensors, a chain's view; they must give the JAX package's answers on random
states and at the boundaries (``since == R``, ``since == 1`` with a zero
drift rate, a cold cache), exactly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.cache import e2crf as je
from fdtpu.diffusion import VPScheduler as JaxVP
from fdtpu.models import score_models as jsm
from fdtpu.sampling import sampler as jsampler
from fdtpu_torch.cache import e2crf as pe
from fdtpu_torch.diffusion import VPScheduler
from fdtpu_torch.models import score_models as psm
from fdtpu_torch.sampling import DiffusionSampler, resident
from fdtpu_torch.utils import conditional, graphs, profiling
from fdtpu_torch.utils.convert import load_jax_variables

# ----------------------------------------------------- decisions, tensor form
L, B, H, T, DH, D, C = 2, 3, 2, 7, 6, 12, 1
INT_FIELDS = ("step", "last_full_step", "cold", "recompute_count", "cache_hit_count",
              "full_steps", "mixed_steps", "cached_steps")


def _random_states(level, seed, n=12, R=10):
    """``n`` random states of ``level`` with the boundaries first: since ==
    R, since == R - 1, since == 1 with a zero drift rate, since == 1 with a
    positive one, a cold cache, step 0."""
    rng = np.random.default_rng(seed)
    fixed = [dict(step=14, last_full_step=14 - R), dict(step=13, last_full_step=14 - R),
             dict(step=5, last_full_step=4, drift_rate=0.0),
             dict(step=5, last_full_step=4, drift_rate=0.1), dict(cold=True), dict(step=0)]
    out = []
    for i in range(n):
        step = int(rng.integers(1, 600))
        f = dict(step=step, last_full_step=int(step - rng.integers(1, 2 * R)), cold=False,
                 drift_rate=float(rng.choice([0.0, rng.uniform(0, 0.2)])),
                 err_acc=float(rng.uniform(0, 0.6)), overrun=float(rng.uniform(0.5, 3.0)),
                 delta_tok=(rng.uniform(0, 1, T) * rng.choice([0.0, 0.05, 1.0])).astype(np.float32),
                 last_tok=rng.integers(max(0, step - 15), step + 1, T).astype(np.int32))
        if i < len(fixed):
            f.update(fixed[i])
        f["last_full_step"] = max(0, min(f["last_full_step"], f["step"]))
        out.append(f)
    return out


def _pair(level, fields):
    """A JAX state and the port's, the port's counters a chain's view (0-d
    int64 tensors)."""
    j = je.init_cache_state(je.E2CRFConfig(level=level), L, B, H, T, DH, D, C)
    p = pe.init_cache_state(pe.E2CRFConfig(level=level), B, T, C, "cpu", num_layers=L,
                            n_head=H, head_dim=DH, d_model=D)
    jf, pf = {}, {}
    for name, value in fields.items():
        if name in INT_FIELDS:
            jf[name] = jnp.asarray(value, jnp.bool_ if name == "cold" else jnp.int32)
            pf[name] = value
        else:
            arr = np.asarray(value, np.asarray(getattr(j, name)).dtype)
            jf[name] = jnp.asarray(arr)
            pf[name] = torch.from_numpy(arr.copy())
    p = p.replace(**pf)
    return j.replace(**jf), pe.counter_view(p, pe.counters_of(p))


def _x(seed):
    return np.random.default_rng(seed).standard_normal((B, T, C)).astype(np.float32)


@pytest.mark.parametrize("auto_calibrate", [False, True])
def test_score_skip_decision_on_device_counters_matches_jax(auto_calibrate):
    kw = dict(R=10, tau_0=0.3, auto_calibrate=auto_calibrate)
    jc, pc = je.E2CRFConfig(**kw), pe.E2CRFConfig(**kw)
    seen = set()
    for fields in _random_states("score", 1):
        js, ps = _pair("score", {k: v for k, v in fields.items()
                                 if k not in ("delta_tok", "last_tok")})
        got = pe.score_skip_decision(pc, pc.policy_params("cpu"), ps)
        assert got.dtype == torch.int64 and got.ndim == 0
        want = int(je.score_skip_decision(jc, jc.policy_params(), js))
        assert int(got) == want, fields
        seen.add(want)
    assert seen == {0, 1}


@pytest.mark.parametrize("energy_weighting", [True, False])
def test_token_policy_on_device_counters_matches_jax(energy_weighting):
    kw = dict(level="token", R=10, tau_0=0.1, energy_weighting=energy_weighting)
    jc, pc = je.E2CRFConfig(**kw), pe.E2CRFConfig(**kw)
    seen = set()
    for i, fields in enumerate(_random_states("token", 2)):
        js, ps = _pair("token", fields)
        x = _x(i)
        jmode, jw, jmean = je.token_policy(jc, jc.policy_params(), js, jnp.asarray(x))
        mode, w, mean = pe.token_policy(pc, pc.policy_params("cpu"), ps, torch.from_numpy(x))
        assert mode.dtype == torch.int64 and int(mode) == int(jmode), fields
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
        seen.add(int(mode))
    assert seen == {pe.TOKEN_FULL, pe.TOKEN_TOPK, pe.TOKEN_SKIP}


@pytest.mark.parametrize("probes", [0.0, 0.4])
def test_event_policy_on_device_counters_matches_jax(probes):
    kw = dict(level="kv", R=10, K=0, tau_0=0.6, tau_warn=0.8, random_probe_ratio=probes)
    jc, pc = je.E2CRFConfig(**kw), pe.E2CRFConfig(**kw)
    seen = set()
    for i, fields in enumerate(_random_states("kv", 3)):
        js, ps = _pair("kv", {k: v for k, v in fields.items() if k != "last_tok"})
        x, key = _x(10 + i), jax.random.PRNGKey(i)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (T,))))
        jmode, jmask = je.event_policy(jc, jc.policy_params(), js, jnp.asarray(x), key)
        mode, mask, count = pe.event_policy(pc, pc.policy_params("cpu"), ps,
                                            torch.from_numpy(x), u)
        assert int(mode) == int(jmode), fields
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert int(count) == int(np.sum(jmask))
        seen.add(int(mode))
    assert {pe.MODE_FULL, pe.MODE_MIXED} <= seen


@pytest.mark.parametrize("K, R", [(2, 10), (3, 150)])
def test_macro_policy_and_ring_on_device_counters_match_jax(K, R):
    jc, pc = je.E2CRFConfig(level="kv", K=K, R=R), pe.E2CRFConfig(level="kv", K=K, R=R)
    ring = pe.E2CRFConfig(level="kv", use_freqca=True, freq_decomp_interval=4)
    for step in (0, 1, 4, 150, 300, 500, 1000):
        js, ps = _pair("kv", dict(step=step))
        jmode, jmask = je.macro_policy(jc.policy_params(), js, T)
        mode, mask, count = pe.macro_policy(pc.policy_params("cpu"), ps, T)
        assert int(mode) == int(jmode) and int(count) == int(np.sum(jmask)), step
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert bool(pe.kv_ring_due(ring, ps)) == (step % 4 == 0)
        assert not bool(pe.kv_ring_due(pc, ps))


@pytest.mark.parametrize("mode", [pe.MODE_FULL, pe.MODE_MIXED, pe.MODE_CACHED])
def test_count_mode_on_device_counters_matches_jax_and_the_host_ints(mode):
    """The KV level's counters after a step against ``update_after_forward``
    of the JAX package; every level's on device counters against the same
    function on host ints."""
    rng = np.random.default_rng(4)
    fields = dict(step=13, last_full_step=4, full_steps=2, mixed_steps=5, cached_steps=6,
                  recompute_count=40, cache_hit_count=51, cold=True)
    js, ps = _pair("kv", fields)
    mask = np.zeros(T, bool)
    mask[:3] = True
    crf = rng.standard_normal((L, T, D)).astype(np.float32)
    kv = rng.standard_normal((2, L, B, T, H, DH)).astype(np.float32)
    jn = je.update_after_forward(je.E2CRFConfig(level="kv"), js, jnp.int32(mode),
                                 jnp.asarray(mask if mode == pe.MODE_MIXED else
                                             np.full(T, mode == pe.MODE_FULL)),
                                 (jnp.asarray(kv[0]), jnp.asarray(kv[1])), jnp.asarray(crf),
                                 jnp.float32(0.5))
    n = torch.tensor(3)
    pn = pe.count_mode(ps, "kv", torch.tensor(mode), T, n)
    for name in INT_FIELDS[:2] + INT_FIELDS[3:]:
        assert int(getattr(pn, name)) == int(getattr(jn, name)), name
    host = pe.init_cache_state(pe.E2CRFConfig(level="kv"), B, T, C, "cpu", num_layers=L,
                               n_head=H, head_dim=DH, d_model=D).replace(**fields)
    for level, m in (("kv", mode), ("token", mode), ("score", int(mode == 0))):
        dev = pe.count_mode(ps, level, torch.tensor(m), T, n)
        ref = pe.count_mode(host, level, m, T, 3)
        assert [int(getattr(dev, k)) for k in INT_FIELDS] == \
            [int(getattr(ref, k)) for k in INT_FIELDS], level


# ------------------------------------------------------ the resident sampler
TS, CS, BS = 13, 2, 4
SMALL = dict(n_channels=CS, max_len=TS, d_model=16, num_layers=2, n_head=2, dim_feedforward=32)
BETA_MAX = 2.0


@pytest.fixture(scope="module")
def models():
    jcfg = jsm.ScoreModelConfig(**SMALL)
    variables = jsm.init_score_model(jax.random.PRNGKey(3), jcfg)
    net = psm.init_score_model(psm.ScoreModelConfig(**SMALL), device="cpu")
    load_jax_variables(net, jax.tree.map(np.asarray, variables))
    js = JaxVP(fourier_noise_scaling=True, beta_max=BETA_MAX).with_noise_scaling(TS)
    ps = VPScheduler(fourier_noise_scaling=True, beta_max=BETA_MAX).with_noise_scaling(TS, "cpu")
    return (jsm.ScoreModel(config=jcfg, variables=variables, scheduler=js),
            psm.ScoreModel(config=net.config, network=net, scheduler=ps))


def jax_draws(seed, num_batches, n, probes):
    """The JAX DiffusionSampler's prior, step and probe draws, per batch."""
    key = jax.random.PRNGKey(seed)
    prior, steps, uniforms = [], [], []
    for _ in range(num_batches):
        key, k_prior, k_chain = jax.random.split(key, 3)
        prior.append(np.array(jax.random.normal(k_prior, (BS, TS, CS))))
        zs, us = [], []
        for _ in range(n):
            if probes:
                k_chain, k_noise, k_probe = jax.random.split(k_chain, 3)
                us.append(np.array(jax.random.uniform(k_probe, (TS,))))
            else:
                k_chain, k_noise = jax.random.split(k_chain)
            zs.append(np.array(jax.random.normal(k_noise, (BS, TS, CS), jnp.float32)))
        steps.append(np.stack(zs))
        uniforms.append(np.stack(us) if probes else np.zeros((n, TS), np.float32))
    return (torch.from_numpy(np.concatenate(prior)), torch.from_numpy(np.concatenate(steps, 1)),
            torch.from_numpy(np.stack(uniforms)))


LEVELS = {
    # name: (cache_kwargs or None, steps, sampler options)
    "uncached": (None, 10, {}),
    "score": (dict(level="score", R=4, tau_0=0.05), 12, {}),
    "token": (dict(level="token", token_budget=4, tau_0=5.0, R=10, random_probe_ratio=0.2,
                   guard="off"), 12, {}),
    "kv-event": (dict(level="kv", policy="event", K=1, R=5, tau_0=1.0, tau_warn=1e9,
                      random_probe_ratio=0.1, use_freqca=True, freq_decomp_interval=3), 12, {}),
    # 26 steps a batch: the macro policy's MIXED refresh falls on global step 100.
    "kv-macro": (dict(level="kv", policy="macro", K=2, R=100), 26, {}),
    "freqca": (dict(level="score", R=6, tau_0=0.6, eps_predictor="freqca", max_history=4,
                    hermite_order=2, guard="off"), 12, {}),
    "fresca": (dict(level="score", R=4, tau_0=0.05), 12,
               dict(use_fresca=True, fresca_high_scale=1.3)),
}


@pytest.mark.parametrize("per_call, num_batches", [(2, 5), (3, 4)])
@pytest.mark.parametrize("name", list(LEVELS))
def test_resident_sampler_matches_jax_and_the_eager_loop(models, name, per_call, num_batches):
    jmodel, pmodel = models
    kw, n, options = LEVELS[name]
    cache = dict(use_cache=kw is not None, cache_kwargs=kw or {})
    jsamp = jsampler.DiffusionSampler(jmodel, BS, batches_per_call=per_call, **cache, **options)
    want = jsamp.sample(num_batches * BS, n, key=jax.random.PRNGKey(11))
    probes = kw is not None and kw["level"] != "score"
    prior, steps, uniforms = jax_draws(11, num_batches, n, probes)
    draws = dict(prior_noise=prior, step_noise=steps, probe_noise=uniforms if probes else None)
    runs = {}
    for k in (1, per_call):
        sampler = DiffusionSampler(pmodel, BS, batches_per_call=k, **cache, **options)
        runs[k] = (sampler.sample(num_batches * BS, n, **draws), sampler)
    (eager, s1), (got, sk) = runs[1], runs[per_call]
    assert got.shape == want.shape == (num_batches * BS, TS, CS)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=5e-5)
    assert torch.equal(got, eager)
    assert len(sk._chains) == 1
    if kw is None:
        assert sk.last_modes is None
        return
    stats = sk.get_cache_stats()
    want_stats = jsamp.get_cache_stats()
    assert stats.keys() == want_stats.keys()
    for key, value in want_stats.items():
        assert stats[key] == pytest.approx(value, rel=1e-5), key
    assert stats == s1.get_cache_stats()
    assert sk.last_modes.shape == (num_batches, n)
    assert torch.equal(sk.last_modes, s1.last_modes)
    if name == "kv-macro":
        assert stats["mixed_steps"] >= 1
    if name == "token":
        assert stats["mixed_steps"] and stats["cached_steps"] and stats["full_steps"]
    if name in ("freqca", "kv-event"):
        np.testing.assert_allclose(sk.last_cache_state.crf_t_hist.numpy(),
                                   np.asarray(jsamp.last_cache_state.crf_t_hist), rtol=0,
                                   atol=6e-8)


@pytest.mark.parametrize("level", ["token", "kv-event"])
def test_each_step_draws_its_probe_whatever_its_mode(models, level):
    """The token level draws its probe uniforms every step, used only at
    TOPK (the JAX body splits ``k_probe`` every step), the KV event level
    every step with probes on: two settings that take different modes
    advance the generator alike, and the eager loop and the resident chain
    stay on one stream (the same samples and generator state)."""
    _, pmodel = models
    kw = dict(LEVELS[level][0])
    other = dict(kw, tau_0=0.0) if level == "token" else dict(kw, tau_warn=0.0)
    states, modes = [], []
    for cache_kwargs in (kw, other):
        for per_call in (1, 2):
            sampler = DiffusionSampler(pmodel, BS, use_cache=True, cache_kwargs=cache_kwargs,
                                       batches_per_call=per_call)
            g = torch.Generator().manual_seed(6)
            x = sampler.sample(2 * BS, 12, generator=g)
            states.append(g.get_state())
            modes.append((x, sampler.last_modes))
    assert all(torch.equal(s, states[0]) for s in states)
    for a, b in (modes[:2], modes[2:]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(modes[0][1], modes[2][1])


def test_no_generator_draw_inside_the_loop(models, monkeypatch):
    """A resident chain draws from its generator in the prologue alone: the
    steps, which a CUDA graph runs inside a WHILE node, draw nothing."""
    _, pmodel = models
    sampler = DiffusionSampler(pmodel, BS, use_cache=True, cache_kwargs=LEVELS["token"][0],
                               batches_per_call=2)
    phase, draws = ["host"], []
    real_prologue = resident.Chain._prologue

    def prologue(self):
        phase[0] = "prologue"
        real_prologue(self)
        phase[0] = "loop"

    def recording(fn):
        def wrapped(*a, **k):
            if k.get("generator") is not None:
                draws.append(phase[0])
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(resident.Chain, "_prologue", prologue)
    monkeypatch.setattr(torch, "randn", recording(torch.randn))
    monkeypatch.setattr(torch, "rand", recording(torch.rand))
    sampler.sample(2 * BS, 8, generator=torch.Generator().manual_seed(1))
    assert draws.count("prologue") == 2 * (1 + 2 * 8) and "loop" not in draws


def test_loop_graph_counts_each_branch_by_its_runs():
    """The launches a trajectory graph's replays made: the prologue's per
    replay, ``pre`` and ``post`` per step, each branch per run (the kernel
    nodes, counted last, are ``tests/test_torch_tracing.py``'s)."""
    seg = lambda *n: types.SimpleNamespace(launched=n + (0,))  # noqa: E731
    loop = types.SimpleNamespace(prologue_launched=(0, 0, 0, 1, 0), setters=(0,) * 5,
                                 pre=seg(0, 0, 0, 0), post=seg(0, 0, 0, 0),
                                 branches=[seg(10, 0, 0, 0), seg(2, 0, 0, 10), seg(0, 0, 0, 0)])
    got = conditional.LoopGraph.launches(loop, 2, 100, [7, 40, 53])
    assert got == (70 + 80, 0, 0, 2 + 400, 0)
    loop.pre = None
    assert conditional.LoopGraph.launches(loop, 1, 100, [5]) == (1000, 0, 0, 1, 0)


def test_chain_read_adds_the_replays_launches_once(models, monkeypatch):
    """At the end of a call the chain reads its counters once and adds the
    replays' launches (here a stand-in loop graph) to the kernels' counts,
    and the steps, branch runs and kernel nodes to the recorder's counters."""
    _, pmodel = models
    for module, name in graphs.COUNTERS:
        monkeypatch.setattr(module, name, 0)
    sampler = DiffusionSampler(pmodel, BS, use_cache=True, cache_kwargs=LEVELS["score"][0],
                               batches_per_call=2)
    sampler.sample(2 * BS, 6, generator=torch.Generator().manual_seed(2))
    (chain,) = sampler._chains.values()
    seen = []
    chain.loop = types.SimpleNamespace(
        launches=lambda replays, steps, runs: seen.append((replays, steps, runs))
        or (1, 2, 3, 4, 5, 6, 7, 8, 212), counted=True)
    chain.replays = 2
    chain.clock[resident.RUNS:] = torch.tensor([3, 8, 1])
    with profiling.recording():
        state, stats = chain.read(stats=True)
    assert profiling.export()["counters"] == {
        "chain.steps": 12, "chain.runs.skip": 3, "chain.runs.refresh": 8,
        "chain.runs.cold_refresh": 1, "chain.kernels": 212}
    assert seen == [(2, 2 * 6, [3, 8, 1])] and graphs.launch_counts() == (1, 2, 3, 4, 5, 6, 7, 8)
    assert int(chain.clock[resident.RUNS:].sum()) == 0 and chain.replays == 0
    assert len(stats) == 7 and state.step == sampler.last_cache_state.step == 12


@pytest.mark.parametrize("name", ["uncached", "score", "token", "kv-event"])
def test_a_dropped_sampler_frees_its_chain_at_once(models, name):
    """A resident chain keeps no reference to itself: dropping its sampler
    frees it (and on a card its graphs) at once, with the garbage collector
    off, and not at a later collection, which could fall inside another
    graph's capture, where destroying a graph is refused."""
    import gc
    import weakref

    _, pmodel = models
    kw, _, options = LEVELS[name]
    gc.disable()
    try:
        sampler = DiffusionSampler(pmodel, BS, use_cache=kw is not None, cache_kwargs=kw or {},
                                   batches_per_call=2, **options)
        sampler.sample(2 * BS, 3, generator=torch.Generator().manual_seed(0))
        (chain,) = sampler._chains.values()
        ref = weakref.ref(chain)
        del chain, sampler
        assert ref() is None
    finally:
        gc.enable()
