"""Port parity: the token- and KV-level E²-CRF cache functions, fdtpu_torch
against fdtpu, on hand-built states.  Modes, masks and counters must agree
exactly; float tensors at rtol 1e-6 (the same float32 operations in two
libraries).  Also the two places where torch's defaults differ from JAX's:
the order of ties in a top-k and the median of an even count."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.cache import e2crf as je
from fdtpu_torch.cache import e2crf as pe
from fdtpu_torch.sampling import sampler as psampler

L, B, H, T, DH, D, C = 2, 3, 2, 7, 6, 12, 1
HOST = ("step", "last_full_step", "cold", "recompute_count", "cache_hit_count", "full_steps",
        "mixed_steps", "cached_steps", "guard_measurements")


def _states(level, kv_dtype=jnp.float32, **fields):
    """A JAX and a port state of ``level`` with the same field values."""
    j = je.init_cache_state(je.E2CRFConfig(level=level), L, B, H, T, DH, D, C, kv_dtype=kv_dtype)
    p = pe.init_cache_state(pe.E2CRFConfig(level=level), B, T, C, "cpu", num_layers=L, n_head=H,
                            head_dim=DH, d_model=D,
                            kv_dtype=torch.bfloat16 if kv_dtype == jnp.bfloat16 else torch.float32)
    jf, pf = {}, {}
    for name, value in fields.items():
        if name in HOST:
            jf[name] = jnp.asarray(value, jnp.bool_ if isinstance(value, bool) else jnp.int32)
            pf[name] = value
        else:
            value = np.asarray(value, np.asarray(getattr(j, name)).dtype)
            jf[name] = jnp.asarray(value)
            pf[name] = torch.from_numpy(value.copy())
    return j.replace(**jf), p.replace(**pf)


def _as_numpy(value):
    if isinstance(value, torch.Tensor):
        return value.float().numpy() if value.dtype == torch.bfloat16 else value.numpy()
    return np.asarray(value)


@pytest.mark.parametrize("level, kv_dtype", [("token", jnp.float32), ("kv", jnp.float32),
                                             ("kv", jnp.bfloat16)])
def test_init_cache_state_matches_jax(level, kv_dtype):
    j, p = _states(level, kv_dtype)
    for f in dataclasses.fields(pe.CacheState):
        jv, pv = np.asarray(getattr(j, f.name), np.float32), _as_numpy(getattr(p, f.name))
        assert jv.shape == pv.shape, f.name
        np.testing.assert_array_equal(pv, jv, err_msg=f.name)
    assert p.k.dtype == (torch.bfloat16 if kv_dtype == jnp.bfloat16 else torch.float32)
    assert p.crf_prev.dtype == p.k.dtype and p.delta_tok.dtype == torch.float32
    if level == "token":
        assert p.last_tok.dtype == torch.int32 and p.eps_norm_ref.shape == (T,)


def test_init_cache_state_needs_the_model_sizes():
    with pytest.raises(ValueError, match="num_layers"):
        pe.init_cache_state(pe.E2CRFConfig(level="token"), B, T, C, "cpu")
    with pytest.raises(ValueError, match="d_model"):
        pe.init_cache_state(pe.E2CRFConfig(level="kv"), B, T, C, "cpu", num_layers=L, n_head=H,
                            head_dim=DH)


@pytest.mark.parametrize("K, R", [(0, 10), (2, 100), (20, 150)])
@pytest.mark.parametrize("step", [0, 1, 100, 150, 300, 500])
def test_macro_policy_matches_jax(K, R, step):
    js, ps = _states("kv", step=step)
    jp, pp = je.E2CRFConfig(K=K, R=R).policy_params(), pe.E2CRFConfig(K=K, R=R).policy_params()
    jmode, jmask = je.macro_policy(jp, js, T)
    mode, mask, count = pe.macro_policy(pp, ps, T)
    assert mode == int(jmode)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert count == int(np.sum(jmask))


def _drift(seed, scale=1.0):
    return np.random.default_rng(seed).uniform(0, scale, T).astype(np.float32)


EVENT_CASES = {
    "first-step": dict(fields=dict(step=0), kw={}),
    "interval": dict(fields=dict(step=15, last_full_step=5), kw=dict(R=10)),
    "warn": dict(fields=dict(step=7, last_full_step=5, delta_tok=_drift(1, 2.0)),
                 kw=dict(tau_warn=0.5)),
    "mixed-triggers": dict(fields=dict(step=7, last_full_step=5, delta_tok=_drift(2)),
                           kw=dict(K=0, tau_0=0.6, tau_warn=1e9)),
    "mixed-anchors": dict(fields=dict(step=7, last_full_step=5), kw=dict(K=3, tau_warn=1e9)),
    "cached": dict(fields=dict(step=7, last_full_step=5, delta_tok=_drift(3, 0.1)),
                   kw=dict(K=0, tau_0=10.0, tau_warn=1e9)),
    "probes": dict(fields=dict(step=7, last_full_step=5), kw=dict(K=0, tau_warn=1e9,
                                                                  random_probe_ratio=0.4)),
    "no-energy-weighting": dict(fields=dict(step=7, last_full_step=5, delta_tok=_drift(4)),
                                kw=dict(K=0, tau_0=0.5, tau_warn=1e9, energy_weighting=False)),
}


@pytest.mark.parametrize("case", list(EVENT_CASES))
def test_event_policy_matches_jax(case):
    fields, kw = EVENT_CASES[case]["fields"], EVENT_CASES[case]["kw"]
    js, ps = _states("kv", **fields)
    jc, pc = je.E2CRFConfig(level="kv", **kw), pe.E2CRFConfig(level="kv", **kw)
    x = np.random.default_rng(5).standard_normal((B, T, C)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (T,))))
    jmode, jmask = je.event_policy(jc, jc.policy_params(), js, jnp.asarray(x), key)
    mode, mask, count = pe.event_policy(pc, pc.policy_params(), ps, torch.from_numpy(x), u)
    assert mode == int(jmode)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert count == int(np.sum(jmask))
    want = {"first-step": 0, "interval": 0, "warn": 0, "cached": 2}.get(case, 1)
    assert mode == want


TOKEN_CASES = {
    "cold": dict(cold=True),
    "interval": dict(cold=False, step=20, last_full_step=8),
    "calibration": dict(cold=False, step=9, last_full_step=8),
    "after-calibration-skip": dict(cold=False, step=9, last_full_step=8,
                                   delta_tok=_drift(6, 0.01)),
    "topk": dict(cold=False, step=12, last_full_step=8, delta_tok=_drift(7, 0.5),
                 last_tok=np.array([8, 9, 10, 11, 8, 8, 9], np.int32)),
    "skip": dict(cold=False, step=12, last_full_step=8, delta_tok=_drift(8, 0.02),
                 last_tok=np.array([8, 9, 10, 11, 8, 8, 9], np.int32)),
    "auto-calibrated-topk": dict(cold=False, step=12, last_full_step=8, delta_tok=_drift(8, 0.02),
                                 last_tok=np.full(T, 8, np.int32), overrun=8.0),
}


@pytest.mark.parametrize("energy_weighting", [True, False])
@pytest.mark.parametrize("case", list(TOKEN_CASES))
def test_token_policy_matches_jax(case, energy_weighting):
    kw = dict(level="token", R=10, tau_0=0.1, energy_weighting=energy_weighting,
              auto_calibrate=case.startswith("auto"))
    js, ps = _states("token", **TOKEN_CASES[case])
    jc, pc = je.E2CRFConfig(**kw), pe.E2CRFConfig(**kw)
    x = np.random.default_rng(10).standard_normal((B, T, C)).astype(np.float32)
    jmode, jw, jmean = je.token_policy(jc, jc.policy_params(), js, jnp.asarray(x))
    mode, w, mean = pe.token_policy(pc, pc.policy_params(), ps, torch.from_numpy(x))
    assert mode == int(jmode)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(mean.item(), float(jmean), rtol=1e-6)
    want = {"topk": pe.TOKEN_TOPK, "skip": pe.TOKEN_SKIP, "after-calibration-skip": pe.TOKEN_SKIP,
            "auto-calibrated-topk": pe.TOKEN_TOPK}.get(case, pe.TOKEN_FULL)
    if energy_weighting:
        assert mode == want


@pytest.mark.parametrize("mode", [pe.MODE_FULL, pe.MODE_MIXED, pe.MODE_CACHED])
def test_update_after_forward_matches_jax(mode):
    rng = np.random.default_rng(11)
    fields = dict(step=13, last_full_step=4, full_steps=2, mixed_steps=5, cached_steps=6,
                  recompute_count=40, cache_hit_count=51,
                  crf_prev=rng.standard_normal((L, T, D)).astype(np.float32))
    js, ps = _states("kv", **fields)
    crf = rng.standard_normal((L, T, D)).astype(np.float32)
    k = rng.standard_normal((L, B, T, H, DH)).astype(np.float32)
    v = rng.standard_normal((L, B, T, H, DH)).astype(np.float32)
    mask = rng.uniform(size=T) < 0.5
    cfg = dict(level="kv")
    jn = je.update_after_forward(je.E2CRFConfig(**cfg), js, jnp.int32(mode), jnp.asarray(mask),
                                 (jnp.asarray(k), jnp.asarray(v)), jnp.asarray(crf),
                                 jnp.float32(0.3))
    pn = pe.update_after_forward(pe.E2CRFConfig(**cfg), ps, mode, int(mask.sum()),
                                 (torch.from_numpy(k), torch.from_numpy(v)), torch.from_numpy(crf))
    for f in HOST[1:-1]:
        assert getattr(pn, f) == int(getattr(jn, f)), f
    for f in ("k", "v", "crf_prev"):
        np.testing.assert_array_equal(getattr(pn, f).numpy(), np.asarray(getattr(jn, f)))
    np.testing.assert_allclose(pn.delta_tok.numpy(), np.asarray(jn.delta_tok), rtol=1e-6)
    with pytest.raises(NotImplementedError, match="FreqCa"):
        pe.update_after_forward(pe.E2CRFConfig(level="kv", use_freqca=True), ps, mode, 0,
                                (torch.from_numpy(k), torch.from_numpy(v)), torch.from_numpy(crf))


@pytest.mark.parametrize("tau_0", [0.1, 100.0])
def test_compute_event_intensity_matches_jax(tau_0):
    rng = np.random.default_rng(12)
    prev = rng.standard_normal((L, T, D)).astype(np.float32)
    crf = rng.standard_normal((L, T, D)).astype(np.float32)
    js, ps = _states("kv", crf_prev=prev)
    want = je.compute_event_intensity(je.E2CRFConfig(tau_0=tau_0), js, jnp.asarray(crf))
    got = pe.compute_event_intensity(pe.E2CRFConfig(tau_0=tau_0), ps, torch.from_numpy(crf))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("measured", [True, False])
def test_record_guard_measurement_decided_on_the_device_matches_jax(measured):
    js, ps = _states("token", realized_err_sum=1.0, predicted_err_sum=0.5, realized_err_max=0.7,
                     guard_measurements=3, overrun=1.5)
    jn = je.record_guard_measurement(js, jnp.asarray(measured), jnp.float32(2.0),
                                     jnp.float32(0.2), jnp.float32(1.5))
    pn = pe.record_guard_measurement(ps, torch.tensor(measured), torch.tensor(2.0),
                                     torch.tensor(0.2), torch.tensor(1.5))
    assert int(pn.guard_measurements) == int(jn.guard_measurements)
    for name in ("realized_err_sum", "predicted_err_sum", "realized_err_max", "overrun"):
        np.testing.assert_allclose(getattr(pn, name).item(), float(getattr(jn, name)),
                                   rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("level", ["token", "kv"])
def test_cache_stats_match_jax(level):
    rng = np.random.default_rng(13)
    fields = dict(step=40, full_steps=5, mixed_steps=20, cached_steps=15, recompute_count=150,
                  cache_hit_count=130, guard_measurements=4, realized_err_sum=1.2,
                  predicted_err_sum=0.1, realized_err_max=0.6, overrun=3.0)
    if level == "token":
        fields.update(eps_norm_ref=rng.uniform(1, 3, T), eps_norm_cold=rng.uniform(0, 2, T))
        fields["eps_norm_cold"][2] = 0.0
    js, ps = _states(level, **fields)
    want, got = je.cache_stats(js), pe.cache_stats(ps)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, int):
            assert got[key] == value, key
        else:
            np.testing.assert_allclose(got[key], value, rtol=1e-6, err_msg=key)


def test_cache_stats_take_a_device_counted_guard():
    _, ps = _states("token", guard_measurements=2, realized_err_sum=1.0)
    stats = pe.cache_stats(ps.replace(guard_measurements=torch.tensor(4, dtype=torch.int32)))
    assert stats["guard_measurements"] == 4 and stats["realized_err_mean"] == 0.25


def test_topk_rows_keep_jax_tie_order_where_torch_topk_does_not():
    """The anchor (2e9) and probe (1e9) bonuses swamp the float32 error
    (an ulp is 128 at 2e9), so ties at the budget edge are routine."""
    priority = np.float32([0.5, 2e9 + 3, 1e9 + 0.7, 2e9, 1e9 + 0.2, 1e9, 0.9])
    want = np.asarray(jax.lax.top_k(jnp.asarray(priority), 4)[1])
    got = psampler._topk_rows(torch.from_numpy(priority), 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(want) == [1, 2, 3, 4]
    assert sorted(torch.topk(torch.from_numpy(priority), 4).indices.tolist()) != sorted(want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("budget", [1, 6, 24])
def test_topk_rows_match_jax_on_ties_and_negatives(seed, budget):
    rng = np.random.default_rng(seed)
    priority = rng.choice(np.float32([-3.5, -0.25, 0.0, 0.7, 2e9, 1e9, 5.0]), 40)
    priority[::7] += rng.standard_normal(6).astype(np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(priority), budget)[1])
    got = psampler._topk_rows(torch.from_numpy(priority), budget).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("values", [[1.0, 2.0, 3.0, 4.0], [0.3, 2.7, 1.1, 9.0, 4.4, 0.2],
                                    [5.0, 1.0, 3.0]])
def test_median_is_jax_median(values):
    x = np.float32(values)
    got = psampler._median(torch.from_numpy(x)).item()
    assert got == float(jnp.median(jnp.asarray(x)))
    if len(values) % 2 == 0:
        assert torch.median(torch.from_numpy(x)).item() != got
