"""Port parity: the score-level E²-CRF cache functions, fdtpu_torch against
fdtpu, on hand-built states.  Decisions must agree exactly; float statistics
at rtol 1e-6 (the same float32 operations in two libraries)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.cache import e2crf as je
from fdtpu_torch.cache import e2crf as pe


def _states(**fields):
    """A JAX and a port score-level state with the same field values."""
    j = je.init_cache_state(je.E2CRFConfig(level="score"), 2, 3, 2, 5, 6, 12, 1)
    p = pe.init_cache_state(pe.E2CRFConfig(level="score"), 3, 5, 1, "cpu")
    jf, pf = {}, {}
    for name, value in fields.items():
        if isinstance(value, (bool, int)) and not isinstance(getattr(p, name), torch.Tensor):
            jf[name] = jnp.asarray(value, jnp.bool_ if isinstance(value, bool) else jnp.int32)
            pf[name] = value
        else:
            jf[name] = jnp.asarray(value, jnp.float32)
            pf[name] = torch.tensor(value, dtype=torch.float32)
    return j.replace(**jf), p.replace(**pf)


def test_config_mirrors_jax_fields_and_defaults():
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert fields(pe.E2CRFConfig) == fields(je.E2CRFConfig)
    for level in ("score", "token", "kv"):
        jc, pc = je.E2CRFConfig(level=level, R=50), pe.E2CRFConfig(level=level, R=50)
        assert pc.resolved_random_probe_ratio == jc.resolved_random_probe_ratio
        assert pc.resolved_guard_abs_tol == jc.resolved_guard_abs_tol


def test_policy_params_match_jax():
    cfg = dict(K=7, R=100, tau_0=1.35, tau_warn=0.5)
    jp = je.E2CRFConfig(**cfg).policy_params()
    pp = pe.E2CRFConfig(**cfg).policy_params("cpu")
    assert (pp.K, pp.R) == (int(jp.K), int(jp.R))
    for name in ("tau_0", "tau_warn", "random_probe_ratio", "guard_abs_tol"):
        assert getattr(pp, name).dtype == torch.float32
        assert getattr(pp, name).item() == float(getattr(jp, name))


def test_init_cache_state_matches_jax_score_fields():
    j = je.init_cache_state(je.E2CRFConfig(level="score"), 2, 3, 2, 5, 6, 12, 1)
    p = pe.init_cache_state(pe.E2CRFConfig(level="score"), 3, 5, 1, "cpu")
    for f in dataclasses.fields(pe.CacheState):
        jv, pv = np.asarray(getattr(j, f.name)), getattr(p, f.name)
        pv = pv.numpy() if isinstance(pv, torch.Tensor) else np.asarray(pv)
        assert jv.shape == pv.shape, f.name
        np.testing.assert_array_equal(pv, jv, err_msg=f.name)


@pytest.mark.parametrize("cfg", [dict(level="score", eps_predictor="freqca", max_history=4),
                                 dict(level="kv", use_freqca=True, max_history=3),
                                 dict(level="kv", use_freqca=True, kv_dtype="bfloat16"),
                                 dict(level="token", use_freqca=True)],
                         ids=["score-freqca", "kv-freqca", "kv-freqca-bf16", "token"])
def test_freqca_ring_fields_match_jax(cfg):
    """FreqCa's history ring: the score level
    keeps ε̂ parts (max_history, B, T, C), the KV level CRF parts
    (max_history, L, T, D) in the store's dtype, the token level none."""
    cfg = dict(cfg)
    bf16 = cfg.pop("kv_dtype", None) == "bfloat16"
    j = je.init_cache_state(je.E2CRFConfig(**cfg), 2, 3, 2, 5, 6, 12, 1,
                            kv_dtype=jnp.bfloat16 if bf16 else None)
    p = pe.init_cache_state(pe.E2CRFConfig(**cfg), 3, 5, 1, "cpu", num_layers=2, n_head=2,
                            head_dim=6, d_model=12,
                            kv_dtype=torch.bfloat16 if bf16 else torch.float32)
    for name in ("crf_low", "crf_high_hist", "crf_t_hist", "hist_len"):
        jv, pv = np.asarray(getattr(j, name)), getattr(p, name)
        assert tuple(pv.shape) == jv.shape, name
        assert str(pv.dtype).split(".")[-1] == str(jv.dtype), name
        np.testing.assert_array_equal(pv.float().numpy(), jv.astype(np.float32), err_msg=name)
    assert p.hist_len.ndim == 0 and p.hist_len.dtype == torch.int32


DECISION_CASES = [
    dict(cold=True),
    dict(cold=False, step=5, last_full_step=4, drift_rate=0.0),  # calibration
    dict(cold=False, step=5, last_full_step=4, drift_rate=0.1, err_acc=0.0),
    dict(cold=False, step=14, last_full_step=4, drift_rate=0.1, err_acc=0.0),  # R
    dict(cold=False, step=9, last_full_step=4, drift_rate=0.1, err_acc=0.3),
    dict(cold=False, step=9, last_full_step=4, drift_rate=0.1, err_acc=0.29999998),
    dict(cold=False, step=9, last_full_step=4, drift_rate=0.1, err_acc=0.3, overrun=2.0),
    dict(cold=False, step=9, last_full_step=4, drift_rate=0.1, err_acc=0.16, overrun=2.0),
]


@pytest.mark.parametrize("auto_calibrate", [False, True])
@pytest.mark.parametrize("fields", DECISION_CASES)
def test_score_skip_decision_and_effective_tau_match_jax(fields, auto_calibrate):
    kw = dict(R=10, tau_0=0.3, auto_calibrate=auto_calibrate)
    jc, pc = je.E2CRFConfig(**kw), pe.E2CRFConfig(**kw)
    js, ps = _states(**fields)
    jp, pp = jc.policy_params(), pc.policy_params("cpu")
    assert pe.score_skip_decision(pc, pp, ps) == bool(je.score_skip_decision(jc, jp, js))
    assert pe.effective_tau(pc, pp, ps).item() == float(je.effective_tau(jc, jp, js))


@pytest.mark.parametrize("eps_norm, norm_ref", [(5.0, 10.0), (0.5, 10.0), (0.0, 0.0)])
def test_guard_relative_error_has_the_ten_percent_floor(eps_norm, norm_ref):
    delta = 0.25
    want = float(je.guard_relative_error(jnp.float32(delta), jnp.float32(eps_norm),
                                         jnp.float32(norm_ref)))
    got = pe.guard_relative_error(torch.tensor(delta), torch.tensor(eps_norm),
                                  torch.tensor(norm_ref)).item()
    np.testing.assert_equal(got, want)


@pytest.mark.parametrize("measured", [True, False])
@pytest.mark.parametrize("realized, predicted", [(0.4, 0.2), (3.0, 0.01), (0.01, 0.5)])
def test_record_guard_measurement_matches_jax(measured, realized, predicted):
    js, ps = _states(realized_err_sum=1.0, predicted_err_sum=0.5, realized_err_max=0.7,
                     guard_measurements=3, overrun=1.5)
    abs_tol = 2.5
    jn = je.record_guard_measurement(js, jnp.asarray(measured), jnp.float32(realized),
                                     jnp.float32(predicted), jnp.float32(abs_tol))
    pn = pe.record_guard_measurement(ps, measured, torch.tensor(realized),
                                     torch.tensor(predicted), torch.tensor(abs_tol))
    assert pn.guard_measurements == int(jn.guard_measurements)
    for name in ("realized_err_sum", "predicted_err_sum", "realized_err_max", "overrun"):
        np.testing.assert_allclose(getattr(pn, name).item(), float(getattr(jn, name)),
                                   rtol=1e-6, err_msg=name)


def test_cache_stats_match_jax():
    fields = dict(step=40, full_steps=7, cached_steps=33, recompute_count=7 * 5,
                  cache_hit_count=33 * 5, guard_measurements=4, realized_err_sum=1.2,
                  predicted_err_sum=0.1, realized_err_max=0.6, overrun=3.0,
                  eps_norm_ref=4.0, eps_norm_cold=2.5)
    js, ps = _states(**fields)
    want, got = je.cache_stats(js), pe.cache_stats(ps)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, int):
            assert got[key] == value, key
        else:
            np.testing.assert_allclose(got[key], value, rtol=1e-6, err_msg=key)
