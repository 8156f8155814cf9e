"""Port parity: the cached forwards and the token- and KV-level E²-CRF chains,
fdtpu_torch against fdtpu, with the same weights, the same K/V stores and
the JAX chains' own noise and probe uniforms handed to the port.

The JAX chain draws, per step, ``k, k_noise, k_probe = split(k, 3)`` at the
token and KV levels; ``z = normal(k_noise, x.shape)`` and the probe uniforms
``uniform(k_probe, (T,))`` are replayed here.  The chains use VP with
β_max = 2, as tests/test_torch_sampling.py does.

The step modes are recorded on both sides by wrapping the policy functions
(on the JAX side through ``jax.debug.callback``, under a freshly jitted
chain so that no compiled program from elsewhere skips the recording).

Tolerances: the forwards at atol 1e-5 (float32 in both libraries); chain
samples at atol 1e-4; the step mode, and the rows each TOPK step
recomputes, must agree at every step; integer cache statistics exactly,
float ones at rtol 1e-4.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.cache import e2crf as je
from fdtpu.diffusion import VPScheduler as JaxVP
from fdtpu.kernels import blockdiag_attention as jax_bda
from fdtpu.models import score_models as jsm
from fdtpu.sampling import sampler as jsampler
from fdtpu_torch.cache import e2crf as pe
from fdtpu_torch.diffusion import VPScheduler
from fdtpu_torch.models import MODE_CACHED, MODE_FULL, MODE_MIXED
from fdtpu_torch.models import score_models as psm
from fdtpu_torch.sampling import resident as president
from fdtpu_torch.sampling import sampler as psampler
from fdtpu_torch.utils.convert import load_jax_variables

T, C, B = 17, 2, 4
L, H, DH, D = 2, 2, 6, 12
# A width of its own (FFN 20): no other test compiles a JAX chain of this model.
SMALL = dict(n_channels=C, max_len=T, d_model=D, num_layers=L, n_head=H, dim_feedforward=20)
BETA_MAX = 2.0


def _interpret_blockdiag(mp):
    """Route the JAX model's blockdiag kernel through Pallas interpret mode,
    as tests/test_torch_models.py does, so MODE_FULL runs on the CPU."""
    orig = jax_bda.blockdiag_mha

    def interp(q, k, v, q_tile=256, interpret=False, shift=True):
        return orig(q, k, v, q_tile=q_tile, interpret=True, shift=shift)

    mp.setattr(jax_bda, "blockdiag_mha", interp)


@pytest.fixture(scope="module")
def pair():
    """JAX and port models with the same weights, per attention_impl."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _interpret_blockdiag(mp)
        for impl in ("einsum", "blockdiag"):
            jcfg = jsm.ScoreModelConfig(**SMALL, attention_impl=impl)
            variables = jsm.init_score_model(jax.random.PRNGKey(0), jcfg)
            net = psm.init_score_model(psm.ScoreModelConfig(**SMALL, attention_impl=impl),
                                       device="cpu")
            load_jax_variables(net, jax.tree.map(np.asarray, variables))
            out[impl] = (jcfg, variables, net)
        yield out


def _forward_inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, B).astype(np.float32)
    k = rng.standard_normal((L, B, T, H, DH)).astype(np.float32)
    v = rng.standard_normal((L, B, T, H, DH)).astype(np.float32)
    mask = rng.uniform(size=T) < 0.4
    return x, t, k, v, mask


@pytest.mark.parametrize("mode", [MODE_FULL, MODE_MIXED, MODE_CACHED],
                         ids=["full", "mixed", "cached"])
@pytest.mark.parametrize("impl", ["einsum", "blockdiag"])
def test_score_apply_cached_matches_jax(pair, impl, mode, monkeypatch):
    _interpret_blockdiag(monkeypatch)
    jcfg, variables, net = pair[impl]
    x, t, k, v, mask = _forward_inputs()
    score, (jk, jv), jcrf = jsm.score_apply_cached(
        variables, jcfg, jnp.asarray(x), jnp.asarray(t), (jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(mask), mode)
    store = (torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    got, kv, crf = psm.score_apply_cached(net, torch.from_numpy(x), torch.from_numpy(t), store,
                                          torch.from_numpy(mask), mode)
    assert kv[0] is store[0] and kv[1] is store[1]  # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(score), atol=1e-5)
    np.testing.assert_allclose(kv[0].numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(kv[1].numpy(), np.asarray(jv), atol=1e-5)
    assert crf.shape == (L, T, D)
    np.testing.assert_allclose(crf.numpy(), np.asarray(jcrf), atol=1e-5)
    if mode == MODE_CACHED:
        np.testing.assert_array_equal(kv[0].numpy(), k)


@pytest.mark.parametrize("impl", ["einsum", "blockdiag"])
@pytest.mark.parametrize("idx", [[0, 5, 16, 3], list(range(T))], ids=["budget4", "all"])
def test_score_apply_topk_matches_jax(pair, impl, idx):
    jcfg, variables, net = pair[impl]
    x, t, k, v, _ = _forward_inputs(seed=2)
    idx = np.asarray(idx, np.int32)
    rows, (jk, jv) = jsm.score_apply_topk(
        variables, jcfg, jnp.asarray(x), jnp.asarray(t), (jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(idx))
    store = (torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    got, kv = psm.score_apply_topk(net, torch.from_numpy(x), torch.from_numpy(t), store,
                                   torch.from_numpy(idx).long())
    assert got.shape == (B, len(idx), C)
    np.testing.assert_allclose(got.numpy(), np.asarray(rows), atol=1e-5)
    np.testing.assert_allclose(kv[0].numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(kv[1].numpy(), np.asarray(jv), atol=1e-5)


def test_topk_over_every_token_after_a_full_refresh_is_the_full_forward(pair):
    """With the whole sequence as the budget, the token-budget forward over
    a store refreshed by MODE_FULL on the same input is the uncached one."""
    _, _, net = pair["einsum"]
    x, t, k, v, _ = _forward_inputs(seed=3)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    store = (torch.from_numpy(k), torch.from_numpy(v))
    full, _, _ = psm.score_apply_cached(net, xt, tt, store, None, MODE_FULL)
    torch.testing.assert_close(full, psm.score_apply(net, xt, tt), rtol=0, atol=1e-6)
    rows, _ = psm.score_apply_topk(net, xt, tt, store, torch.arange(T))
    torch.testing.assert_close(rows, full, rtol=0, atol=1e-5)


def test_cached_forward_rejects_a_store_of_another_shape_or_dtype(pair):
    _, _, net = pair["einsum"]
    x, t, k, v, _ = _forward_inputs()
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    with pytest.raises(ValueError, match="K/V store"):
        store = (torch.zeros(L, B, T, H, DH + 1),) * 2
        psm.score_apply_cached(net, xt, tt, store, None, MODE_FULL)
    with pytest.raises(ValueError, match="K/V store"):
        store = (torch.from_numpy(k).double(), torch.from_numpy(v).double())
        psm.score_apply_cached(net, xt, tt, store, None, MODE_CACHED)


# ------------------------------------------------------------------ chains
def chain_draws(key, num_steps):
    """The step noise and probe uniforms of a token- or KV-level JAX chain
    started with ``key``: ``k, k_noise, k_probe = split(k, 3)`` per step."""
    zs, us = [], []
    for _ in range(num_steps):
        key, k_noise, k_probe = jax.random.split(key, 3)
        zs.append(np.array(jax.random.normal(k_noise, (B, T, C), jnp.float32)))
        us.append(np.array(jax.random.uniform(k_probe, (T,))))
    return torch.from_numpy(np.stack(zs)), torch.from_numpy(np.stack(us))


@contextlib.contextmanager
def recorded_steps(kw):
    """Record each step's mode, and each TOPK step's rows, on both sides."""
    name = "token_policy" if kw["level"] == "token" else f"{kw.get('policy', 'event')}_policy"
    state_arg = 1 if name == "macro_policy" else 2
    jorig, porig = getattr(jsampler, name), getattr(president, name)
    jtop, ptop = jsampler.score_apply_topk, psampler.score_apply_topk
    rec = dict(jmode=[], pmode=[], jrows=[], prows=[])

    def jpolicy(*a):
        out = jorig(*a)
        jax.debug.callback(lambda s, m: rec["jmode"].append((int(s), int(m))),
                           a[state_arg].step, out[0])
        return out

    def ppolicy(*a):
        out = porig(*a)
        rec["pmode"].append(int(out[0]))
        return out

    def jtopk(variables, cfg, x, t, kv, idx):
        jax.debug.callback(lambda i: rec["jrows"].append(sorted(i.tolist())), idx, ordered=True)
        return jtop(variables, cfg, x, t, kv, idx)

    def ptopk(network, x, t, kv, idx):
        rec["prows"].append(sorted(idx.tolist()))
        return ptop(network, x, t, kv, idx)

    impl = jsampler._sample_chain_impl

    @functools.wraps(impl)
    def fresh(*a, **k):
        return impl(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        _interpret_blockdiag(mp)
        mp.setattr(jsampler, name, jpolicy)
        mp.setattr(president, name, ppolicy)
        mp.setattr(jsampler, "score_apply_topk", jtopk)
        mp.setattr(psampler, "score_apply_topk", ptopk)
        mp.setattr(jsampler, "_sample_chain", jax.jit(
            fresh, donate_argnums=(2,),
            static_argnames=("model_cfg", "cache_cfg", "num_steps", "use_fresca",
                             "fresca_cutoff_ratio", "fresca_cutoff_strategy", "guard_trace")))
        yield rec
    rec["jmode"] = [m for _, m in sorted(rec["jmode"])]


def _modes_agree(rec):
    jm, pm = rec["jmode"], rec["pmode"]
    assert len(jm) == len(pm), (len(jm), len(pm))
    diverged = [i for i, (a, b) in enumerate(zip(jm, pm)) if a != b]
    assert not diverged, f"modes diverge first at step {diverged[0]}: jax {jm} port {pm}"
    assert rec["prows"] == rec["jrows"]


def _stats_agree(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, int):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def schedulers():
    js = JaxVP(fourier_noise_scaling=True, beta_max=BETA_MAX).with_noise_scaling(T)
    ps = VPScheduler(fourier_noise_scaling=True, beta_max=BETA_MAX).with_noise_scaling(T, "cpu")
    return js, ps


CHAINS = {
    # FULL and TOPK only (tau_0 = 0), the default probe ratio 0.02.
    "token-tau0": ("einsum", dict(level="token", token_budget=4, tau_0=0.0, R=8)),
    # FULL, TOPK and SKIP, with probes that fire often.
    "token-skip": ("einsum", dict(level="token", token_budget=4, tau_0=1.0, R=12,
                                  random_probe_ratio=0.2)),
    # FULL (R, tau_warn), MIXED and CACHED.
    "kv-event": ("einsum", dict(level="kv", policy="event", K=0, R=10, tau_0=3.0, tau_warn=2.0)),
    # The kernel implementation: B1 at FULL, the cached attention at MIXED.
    "kv-event-blockdiag": ("blockdiag", dict(level="kv", policy="event", K=1, R=6, tau_0=1.0,
                                             tau_warn=1e9)),
}


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_matches_jax_step_by_step(pair, schedulers, name):
    impl, kw = CHAINS[name]
    jcfg, variables, net = pair[impl]
    js, ps = schedulers
    n = 40
    x0 = np.array(js.prior_sampling(jax.random.PRNGKey(6), (B, T, C)))
    key = jax.random.PRNGKey(8)
    jcc = je.E2CRFConfig(**kw)
    state = je.init_cache_state(jcc, L, B, H, T, DH, D, C)
    z, u = chain_draws(key, n)
    with recorded_steps(kw) as rec:
        want, jstate = jsampler.sample_chain(variables, js, jnp.asarray(x0), key, state,
                                             model_cfg=jcfg, cache_cfg=jcc, num_steps=n)
        got, pstate = psampler.sample_chain(net, ps, torch.from_numpy(x0),
                                            cache_cfg=pe.E2CRFConfig(**kw), num_steps=n,
                                            step_noise=z, probe_noise=u)
    _modes_agree(rec)
    modes = set(rec["pmode"])
    assert modes == {0, 1, 2} or (name in ("token-tau0", "kv-event-blockdiag") and modes == {0, 1})
    _stats_agree(pe.cache_stats(pstate), je.cache_stats(jstate))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for f in ("k", "v", "delta_tok"):
        np.testing.assert_allclose(getattr(pstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                   atol=1e-4, err_msg=f)


FRESCA_CHAINS = {
    "token-skip": dict(level="token", token_budget=4, tau_0=1.0, R=12, random_probe_ratio=0.2),
    "kv-event": dict(level="kv", policy="event", K=0, R=10, tau_0=3.0, tau_warn=2.0),
    # FreqCa's CRF ring at the KV level: it takes the CRF every 3 global
    # steps, so a 40-step chain overfills its 5 entries.
    "kv-event-freqca": dict(level="kv", policy="event", K=0, R=10, tau_0=3.0, tau_warn=2.0,
                            use_freqca=True, max_history=5, freq_decomp_interval=3),
    "kv-macro-freqca": dict(level="kv", policy="macro", K=2, R=100, use_freqca=True,
                            max_history=4, freq_decomp_interval=7),
}


@pytest.mark.parametrize("name", list(FRESCA_CHAINS))
def test_fresca_and_freqca_chains_match_jax_step_by_step(pair, schedulers, name):
    """FreSca after the token and KV levels' forwards (the energy cutoff),
    and the KV level's FreqCa ring: the same mode at every step, samples at
    atol 5e-5, the ring's fields at the end of the chain."""
    kw = FRESCA_CHAINS[name]
    jcfg, variables, net = pair["einsum"]
    js, ps = schedulers
    n = 40
    x0 = np.array(js.prior_sampling(jax.random.PRNGKey(16), (B, T, C)))
    key = jax.random.PRNGKey(17)
    jcc = je.E2CRFConfig(**kw)
    state = je.init_cache_state(jcc, L, B, H, T, DH, D, C)
    z, u = chain_draws(key, n)
    fresca = dict(use_fresca=not kw.get("use_freqca"), fresca_low_scale=1.1,
                  fresca_high_scale=1.4)
    with recorded_steps(kw) as rec:
        want, jstate = jsampler.sample_chain(variables, js, jnp.asarray(x0), key, state,
                                             model_cfg=jcfg, cache_cfg=jcc, num_steps=n,
                                             **fresca)
        got, pstate = psampler.sample_chain(net, ps, torch.from_numpy(x0),
                                            cache_cfg=pe.E2CRFConfig(**kw), num_steps=n,
                                            step_noise=z, probe_noise=u, **fresca)
    _modes_agree(rec)
    assert len(set(rec["pmode"])) >= 2
    _stats_agree(pe.cache_stats(pstate), je.cache_stats(jstate))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    if kw.get("use_freqca"):
        k_hist = kw["max_history"]
        assert int(pstate.hist_len) == int(jstate.hist_len) == k_hist
        assert pstate.crf_high_hist.shape == (k_hist, L, T, D)
        # One float32 ulp of the time grid (ROADMAP.md §C).
        np.testing.assert_allclose(pstate.crf_t_hist.numpy(), np.asarray(jstate.crf_t_hist),
                                   rtol=0, atol=6e-8)
        for f in ("crf_low", "crf_high_hist"):
            np.testing.assert_allclose(getattr(pstate, f).numpy(),
                                       np.asarray(getattr(jstate, f)), atol=5e-5, err_msg=f)


def _jax_sampler_noise(seed, num_batches, n):
    """Prior, step and probe draws of the JAX DiffusionSampler's host loop."""
    key = jax.random.PRNGKey(seed)
    prior, steps, probes = [], [], []
    for _ in range(num_batches):
        key, k_prior, k_chain = jax.random.split(key, 3)
        prior.append(np.array(jax.random.normal(k_prior, (B, T, C))))
        z, u = chain_draws(k_chain, n)
        steps.append(z.numpy())
        probes.append(u.numpy())
    return (torch.from_numpy(np.concatenate(prior)), torch.from_numpy(np.concatenate(steps, 1)),
            torch.from_numpy(np.stack(probes)))


@pytest.mark.parametrize("kw, n", [
    (dict(level="token", token_budget=4, tau_0=1.0, R=12, guard="off"), 25),
    # R = 100: the macro policy's MIXED refresh falls on global step 100, in
    # the second batch.
    (dict(level="kv", policy="macro", K=2, R=100), 60),
], ids=["token", "kv-macro"])
def test_two_batch_sampler_matches_jax(pair, schedulers, kw, n):
    """Quirk Q5 at the token and KV levels: the store persists across the
    two batches, marked cold for the second, and the global step runs on."""
    jcfg, variables, net = pair["einsum"]
    js, ps = schedulers
    seed = 11
    jmodel = jsm.ScoreModel(config=jcfg, variables=variables, scheduler=js)
    pmodel = psm.ScoreModel(config=net.config, network=net, scheduler=ps)
    prior, steps, probes = _jax_sampler_noise(seed, 2, n)
    with recorded_steps(kw) as rec:
        jsamp = jsampler.DiffusionSampler(jmodel, B, use_cache=True, cache_kwargs=kw)
        want = jsamp.sample(2 * B, n, key=jax.random.PRNGKey(seed))
        psamp = psampler.DiffusionSampler(pmodel, B, use_cache=True, cache_kwargs=kw)
        got = psamp.sample(2 * B, n, prior_noise=prior, step_noise=steps, probe_noise=probes)
    _modes_agree(rec)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    got_stats, want_stats = psamp.get_cache_stats(), jsamp.get_cache_stats()
    _stats_agree(got_stats, want_stats)
    assert got_stats["current_step"] == 2 * n
    assert psamp.last_cache_state.k.shape == (L, B, T, H, DH)
    if kw["level"] == "kv":
        assert rec["pmode"][100] == MODE_MIXED and got_stats["mixed_steps"] == 1
    else:
        assert got_stats["full_steps"] >= 2 and got_stats["cached_steps"] >= 1


def test_sampler_draws_probes_from_its_generator(pair, schedulers):
    *_, net = pair["einsum"]
    _, ps = schedulers
    model = psm.ScoreModel(config=net.config, network=net, scheduler=ps)
    kw = dict(level="token", token_budget=4, tau_0=0.0, R=8, random_probe_ratio=0.5)
    sampler = psampler.DiffusionSampler(model, B, use_cache=True, cache_kwargs=kw)
    a = sampler.sample(B, 12, generator=torch.Generator().manual_seed(1))
    b = sampler.sample(B, 12, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (B, T, C) and torch.isfinite(a).all()
    assert sampler.get_cache_stats()["mixed_steps"] > 0
