"""Port parity: reverse-diffusion chains, fdtpu_torch against fdtpu, with the
same weights and the JAX chains' own noise handed to the port.

The noise is reproduced with jax exactly as the JAX sampler draws it: per
step ``k, k_noise = split(k)`` and ``z = normal(k_noise, x.shape)``, per batch
``key, k_prior, k_chain = split(key, 3)``.

The chains use VP with β_max = 2: with random weights the score does not
track x, and under the default β_max = 20 the reverse chain grows x about
e⁵-fold, so an absolute tolerance would measure that growth instead of the
port.  Samples are held per element at atol 1e-4; the score-level schedule
(full or skip) must agree at every step; integer cache statistics exactly,
float ones at rtol 1e-4.
"""

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
from fdtpu_torch.sampling import sampler as psampler
from fdtpu_torch.utils.convert import load_jax_variables

T, C, B = 17, 2, 4
SMALL = dict(n_channels=C, max_len=T, d_model=12, num_layers=2, n_head=2, dim_feedforward=24)
BETA_MAX = 2.0


@pytest.fixture(scope="module")
def models():
    jcfg = jsm.ScoreModelConfig(**SMALL)
    variables = jsm.init_score_model(jax.random.PRNGKey(0), jcfg)
    net = psm.init_score_model(psm.ScoreModelConfig(**SMALL), device="cpu")
    load_jax_variables(net, jax.tree.map(np.asarray, variables))
    js = JaxVP(fourier_noise_scaling=True, beta_max=BETA_MAX).with_noise_scaling(T)
    ps = VPScheduler(fourier_noise_scaling=True, beta_max=BETA_MAX).with_noise_scaling(T, "cpu")
    return jcfg, variables, js, net, ps


def chain_noise(key, num_steps, shape):
    """The per-step draws of the JAX chain started with ``key``."""
    zs = []
    for _ in range(num_steps):
        key, k_noise = jax.random.split(key)
        zs.append(np.array(jax.random.normal(k_noise, shape, jnp.float32)))
    return torch.from_numpy(np.stack(zs))


def _rand_x(seed):
    return np.random.default_rng(seed).standard_normal((B, T, C)).astype(np.float32)


def _x0(js, seed=5):
    return np.array(js.prior_sampling(jax.random.PRNGKey(seed), (B, T, C)))


def test_uncached_chain_matches_jax(models):
    jcfg, variables, js, net, ps = models
    x0, key, n = _x0(js), jax.random.PRNGKey(7), 20
    want, _ = jsampler.sample_chain(variables, js, jnp.asarray(x0), key, None,
                                    model_cfg=jcfg, cache_cfg=None, num_steps=n)
    got, state = psampler.sample_chain(net, ps, torch.from_numpy(x0), num_steps=n,
                                       step_noise=chain_noise(key, n, (B, T, C)))
    assert state is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _stats_agree(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, int):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize(
    "eps_order, tau_0, auto_calibrate",
    [(0, 0.3, False), (1, 1.35, False), (2, 0.3, False), (1, 1.35, True)],
)
def test_score_level_chain_matches_jax_step_by_step(models, eps_order, tau_0, auto_calibrate):
    jcfg, variables, js, net, ps = models
    x0, key, n = _x0(js, seed=6), jax.random.PRNGKey(8), 40
    kw = dict(level="score", R=8, tau_0=tau_0, eps_order=eps_order, auto_calibrate=auto_calibrate)
    jcc = je.E2CRFConfig(**kw)
    state = je.init_cache_state(jcc, 2, B, 2, T, 6, 12, C)
    want, jstate, jtrace = jsampler.sample_chain(
        variables, js, jnp.asarray(x0), key, state, model_cfg=jcfg, cache_cfg=jcc,
        num_steps=n, guard_trace=True,
    )
    got, pstate, ptrace = psampler.sample_chain(
        net, ps, torch.from_numpy(x0), cache_cfg=pe.E2CRFConfig(**kw), num_steps=n,
        step_noise=chain_noise(key, n, (B, T, C)), guard_trace=True,
    )
    full_j = np.asarray(jtrace[4]) > 0
    full_p = ptrace[4].numpy() > 0
    diverged = np.nonzero(full_j != full_p)[0]
    assert diverged.size == 0, f"schedules diverge first at step {diverged[:1]}"
    assert full_j.sum() >= 3 and (~full_j).sum() >= 3
    np.testing.assert_array_equal(ptrace[0].numpy(), np.asarray(jtrace[0]))  # measured
    for j in (1, 2, 3):  # rel, ‖ε̂‖, err_acc at the refreshes after the cold one
        np.testing.assert_allclose(ptrace[j].numpy()[1:], np.asarray(jtrace[j])[1:],
                                   rtol=1e-4, atol=1e-6)
    _stats_agree(pe.cache_stats(pstate), je.cache_stats(jstate))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _rings_agree(pstate, jstate):
    """FreqCa's ring fields at the end of a chain.  The ring's timesteps may
    differ by one float32 ulp: XLA's linspace on the CPU contracts 1 − s into
    a fused multiply-add (ROADMAP.md §C)."""
    assert int(pstate.hist_len) == int(jstate.hist_len)
    np.testing.assert_allclose(pstate.crf_t_hist.numpy(), np.asarray(jstate.crf_t_hist),
                               rtol=0, atol=6e-8)
    for f in ("crf_low", "crf_high_hist"):
        np.testing.assert_allclose(getattr(pstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                   atol=5e-5, err_msg=f)


@pytest.mark.parametrize("hermite_order", [2, 3])
def test_freqca_score_chain_matches_jax_step_by_step(models, hermite_order):
    """The score level's FreqCa predictor: the same refresh schedule at every
    step, the same ring, samples at atol 5e-5.  The ring (4 entries) fills,
    so the fit is extrapolated unclipped once it is determined."""
    jcfg, variables, js, net, ps = models
    x0, key, n = _x0(js, seed=6), jax.random.PRNGKey(8), 40
    kw = dict(level="score", R=6, tau_0=0.6, eps_predictor="freqca", max_history=4,
              hermite_order=hermite_order, guard="off")
    jcc = je.E2CRFConfig(**kw)
    state = je.init_cache_state(jcc, 2, B, 2, T, 6, 12, C)
    want, jstate, jtrace = jsampler.sample_chain(
        variables, js, jnp.asarray(x0), key, state, model_cfg=jcfg, cache_cfg=jcc,
        num_steps=n, guard_trace=True,
    )
    got, pstate, ptrace = psampler.sample_chain(
        net, ps, torch.from_numpy(x0), cache_cfg=pe.E2CRFConfig(**kw), num_steps=n,
        step_noise=chain_noise(key, n, (B, T, C)), guard_trace=True,
    )
    full_j, full_p = np.asarray(jtrace[4]) > 0, ptrace[4].numpy() > 0
    diverged = np.nonzero(full_j != full_p)[0]
    assert diverged.size == 0, f"schedules diverge first at step {diverged[:1]}"
    assert full_j.sum() > hermite_order + 1 and (~full_j).sum() >= 3
    # The realized errors at the refreshes after the cold one.
    np.testing.assert_allclose(ptrace[1].numpy()[1:], np.asarray(jtrace[1])[1:], rtol=1e-4,
                               atol=1e-6)
    _rings_agree(pstate, jstate)
    assert int(pstate.hist_len) == 4
    _stats_agree(pe.cache_stats(pstate), je.cache_stats(jstate))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("kw", [
    None,
    dict(level="score", R=8, tau_0=1.35, eps_order=1),
    dict(level="score", R=6, tau_0=0.6, eps_predictor="freqca", max_history=4, hermite_order=2),
], ids=["uncached", "score", "score-freqca"])
@pytest.mark.parametrize("strategy", ["energy", "spatial"])
def test_fresca_chain_matches_jax(models, kw, strategy):
    """FreSca after the score (uncached) or after the refresh or skip branch
    (score level): samples at atol 5e-5, the same schedule."""
    jcfg, variables, js, net, ps = models
    x0, key, n = _x0(js, seed=9), jax.random.PRNGKey(10), 30
    fresca = dict(use_fresca=True, fresca_low_scale=0.9, fresca_high_scale=1.5,
                  fresca_cutoff_ratio=0.5, fresca_cutoff_strategy=strategy)
    jcc = pcc = state = None
    if kw is not None:
        kw = dict(kw, guard="off")
        jcc, pcc = je.E2CRFConfig(**kw), pe.E2CRFConfig(**kw)
        state = je.init_cache_state(jcc, 2, B, 2, T, 6, 12, C)
    want, jstate = jsampler.sample_chain(variables, js, jnp.asarray(x0), key, state,
                                         model_cfg=jcfg, cache_cfg=jcc, num_steps=n, **fresca)
    got, pstate = psampler.sample_chain(net, ps, torch.from_numpy(x0), cache_cfg=pcc,
                                        num_steps=n, step_noise=chain_noise(key, n, (B, T, C)),
                                        **fresca)
    if kw is not None:
        _stats_agree(pe.cache_stats(pstate), je.cache_stats(jstate))
        assert pstate.full_steps >= 2 and pstate.cached_steps >= 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def _jax_sampler_noise(seed, num_batches, n):
    """Prior and step draws of the JAX DiffusionSampler's host loop."""
    key = jax.random.PRNGKey(seed)
    prior, steps = [], []
    for _ in range(num_batches):
        key, k_prior, k_chain = jax.random.split(key, 3)
        prior.append(np.array(jax.random.normal(k_prior, (B, T, C))))
        steps.append(chain_noise(k_chain, n, (B, T, C)).numpy())
    return torch.from_numpy(np.concatenate(prior)), torch.from_numpy(np.concatenate(steps, 1))


@pytest.mark.parametrize("reset", [False, True])
def test_two_batch_sampler_matches_jax_with_cold_marking(models, reset):
    """Quirk Q5: the cache persists across the two batches and is marked
    cold for the second trajectory (or re-initialized under
    reset_between_batches); the global step counter keeps running."""
    jcfg, variables, js, net, ps = models
    n, seed = 30, 11
    kw = dict(level="score", R=6, tau_0=0.5, eps_order=1, reset_between_batches=reset,
              guard="off")
    jmodel = jsm.ScoreModel(config=jcfg, variables=variables, scheduler=js)
    jsamp = jsampler.DiffusionSampler(jmodel, B, use_cache=True, cache_kwargs=kw)
    want = jsamp.sample(2 * B, n, key=jax.random.PRNGKey(seed))
    pmodel = psm.ScoreModel(config=net.config, network=net, scheduler=ps)
    psamp = psampler.DiffusionSampler(pmodel, B, use_cache=True, cache_kwargs=kw)
    prior, steps = _jax_sampler_noise(seed, 2, n)
    got = psamp.sample(2 * B, n, prior_noise=prior, step_noise=steps)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    got_stats, want_stats = psamp.get_cache_stats(), jsamp.get_cache_stats()
    _stats_agree(got_stats, want_stats)
    assert got_stats["current_step"] == (n if reset else 2 * n)
    assert got_stats["full_steps"] >= 3 and got_stats["cached_steps"] >= 3


def test_freqca_two_batch_sampler_restarts_the_ring_on_the_cold_refresh(models):
    """Quirk Q5 with the FreqCa predictor: the second trajectory's cold
    refresh restarts the ring's live count at 1 (its older entries belong to
    the first trajectory); samples, statistics and ring as the JAX sampler's,
    with FreSca on."""
    jcfg, variables, js, net, ps = models
    n, seed = 24, 12
    kw = dict(level="score", R=6, tau_0=0.6, eps_predictor="freqca", max_history=4,
              hermite_order=2, guard="off")
    fresca = dict(use_fresca=True, fresca_high_scale=1.3)
    jmodel = jsm.ScoreModel(config=jcfg, variables=variables, scheduler=js)
    jsamp = jsampler.DiffusionSampler(jmodel, B, use_cache=True, cache_kwargs=kw, **fresca)
    want = jsamp.sample(2 * B, n, key=jax.random.PRNGKey(seed))
    pmodel = psm.ScoreModel(config=net.config, network=net, scheduler=ps)
    psamp = psampler.DiffusionSampler(pmodel, B, use_cache=True, cache_kwargs=kw, **fresca)
    prior, steps = _jax_sampler_noise(seed, 2, n)
    got = psamp.sample(2 * B, n, prior_noise=prior, step_noise=steps)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    _stats_agree(psamp.get_cache_stats(), jsamp.get_cache_stats())
    _rings_agree(psamp.last_cache_state, jsamp.last_cache_state)


@pytest.mark.parametrize("cold, hist_len, want", [(True, 3, 1), (False, 2, 3), (False, 4, 4)])
def test_freqca_refresh_shifts_the_ring_and_counts_its_live_entries(models, cold, hist_len,
                                                                    want):
    *_, net, ps = models
    cfg = pe.E2CRFConfig(level="score", eps_predictor="freqca", max_history=4, guard="off")
    ring = torch.arange(4, dtype=torch.float32)[:, None, None, None].expand(4, B, T, C)
    state = pe.init_cache_state(cfg, B, T, C, "cpu").replace(
        cold=cold, step=5, last_full_step=3, hist_len=torch.tensor(hist_len, dtype=torch.int32),
        crf_high_hist=ring.clone(), crf_t_hist=torch.tensor([0.9, 0.8, 0.7, 0.6]))
    x = torch.from_numpy(_rand_x(13))
    t = torch.tensor(0.5)
    _, std = ps.marginal_prob(x, t.expand(B))
    _, new, _ = psampler._refresh(net.compute_copy(), state, cfg, cfg.policy_params(), x, t,
                                  t.expand(B), std)
    assert new.hist_len.dtype == torch.int32 and int(new.hist_len) == want
    torch.testing.assert_close(new.crf_high_hist[:3], ring[1:])
    torch.testing.assert_close(new.crf_t_hist, torch.tensor([0.8, 0.7, 0.6, 0.5]))
    torch.testing.assert_close(new.crf_low + new.crf_high_hist[3], new.eps_hat, atol=1e-6,
                               rtol=0)


def test_uncached_sampler_drops_the_remainder_like_jax(models):
    """Quirk Q6: 10 samples at batch 4 → 2 batches, 8 samples."""
    jcfg, variables, js, net, ps = models
    n = 5
    jmodel = jsm.ScoreModel(config=jcfg, variables=variables, scheduler=js)
    want = jsampler.DiffusionSampler(jmodel, B).sample(10, n, key=jax.random.PRNGKey(3))
    prior, steps = _jax_sampler_noise(3, 2, n)
    pmodel = psm.ScoreModel(config=net.config, network=net, scheduler=ps)
    got = psampler.DiffusionSampler(pmodel, B).sample(10, n, prior_noise=prior, step_noise=steps)
    assert got.shape == want.shape == (8, T, C)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_sampler_draws_from_its_generator(models):
    *_, net, ps = models
    model = psm.ScoreModel(config=net.config, network=net, scheduler=ps)
    sampler = psampler.DiffusionSampler(model, B, use_cache=True,
                                        cache_kwargs=dict(R=4, tau_0=1.0, guard="off"))
    a = sampler.sample(B, 6, generator=torch.Generator().manual_seed(1))
    b = sampler.sample(B, 6, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (B, T, C) and torch.isfinite(a).all()


@pytest.mark.parametrize("guard", ["warn", "strict", "off"])
def test_error_budget_guard_warns_raises_or_stays_silent(models, guard):
    *_, net, ps = models
    model = psm.ScoreModel(config=net.config, network=net, scheduler=ps)
    # A zero worst-span tolerance flags any measured skip span.
    kw = dict(R=8, tau_0=1.35, guard=guard, guard_max_tol=0.0)
    sampler = psampler.DiffusionSampler(model, B, use_cache=True, cache_kwargs=kw)
    gen = torch.Generator().manual_seed(2)
    if guard == "warn":
        with pytest.warns(UserWarning, match="error-budget guard"):
            sampler.sample(B, 30, generator=gen)
    elif guard == "strict":
        with pytest.raises(RuntimeError, match="error-budget guard"):
            sampler.sample(B, 30, generator=gen)
    else:
        sampler.sample(B, 30, generator=gen)
    assert sampler.get_cache_stats()["guard_measurements"] > 0


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(mesh=object()), "distribution"),
        (dict(batches_per_call=2), "graph-captured"),
    ],
)
def test_unported_options_raise_not_implemented(models, kwargs, match):
    *_, net, ps = models
    model = psm.ScoreModel(config=net.config, network=net, scheduler=ps)
    with pytest.raises(NotImplementedError, match=match):
        psampler.DiffusionSampler(model, B, **kwargs)


def test_unknown_eps_predictor_is_a_value_error(models):
    *_, net, ps = models
    model = psm.ScoreModel(config=net.config, network=net, scheduler=ps)
    with pytest.raises(ValueError, match="eps_predictor"):
        psampler.DiffusionSampler(model, B, use_cache=True,
                                  cache_kwargs=dict(eps_predictor="spline"))
