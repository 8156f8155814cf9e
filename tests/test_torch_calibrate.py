"""Port parity: τ₀ calibration (``fdtpu_torch/sampling/calibrate.py``)
against the JAX package's ``calibrate_tau_0`` on a tiny model with the same
weights, the JAX draws for the pilot (``key``) and the floor's rerun
(``split(key, 2)[1]``) handed to the port.

The chosen τ₀ and each arm's skip ratio must be equal; the sliced
Wasserstein distances and the floor agree to relative 1e-3 (chains that
agree to ~1e-5 per element, through float64 numpy metrics).
"""

import jax
import numpy as np
import pytest
import torch

from fdtpu.diffusion import VPScheduler as JaxVP
from fdtpu.models import score_models as jsm
from fdtpu.sampling import calibrate_tau_0 as jax_calibrate
from fdtpu_torch.diffusion import VPScheduler
from fdtpu_torch.models import score_models as psm
from fdtpu_torch.sampling import DEFAULT_LADDER, TauCalibration, calibrate_tau_0
from fdtpu_torch.utils.convert import load_jax_variables

T, C, N, BATCH, STEPS = 16, 1, 16, 8, 30
SMALL = dict(n_channels=C, max_len=T, d_model=16, num_layers=2, n_head=2, dim_feedforward=32)
BETA_MAX = 2.0


@pytest.fixture(scope="module")
def models():
    jcfg = jsm.ScoreModelConfig(**SMALL)
    variables = jsm.init_score_model(jax.random.PRNGKey(3), jcfg)
    net = psm.init_score_model(psm.ScoreModelConfig(**SMALL), device="cpu")
    load_jax_variables(net, jax.tree.map(np.asarray, variables))
    js = JaxVP(fourier_noise_scaling=True, beta_max=BETA_MAX).with_noise_scaling(T)
    ps = VPScheduler(fourier_noise_scaling=True, beta_max=BETA_MAX).with_noise_scaling(T, "cpu")
    jmodel = jsm.ScoreModel(config=jcfg, variables=variables, scheduler=js)
    pmodel = psm.ScoreModel(config=net.config, network=net, scheduler=ps)
    return jmodel, pmodel


def sampler_draws(key, num_batches, n):
    """Prior and step draws of the JAX DiffusionSampler's host loop at the
    score level and uncached: per batch ``key, k_prior, k_chain =
    split(key, 3)``, per step ``k, k_noise = split(k)``."""
    prior, steps = [], []
    for _ in range(num_batches):
        key, k_prior, k_chain = jax.random.split(key, 3)
        prior.append(np.array(jax.random.normal(k_prior, (BATCH, T, C))))
        zs = []
        for _ in range(n):
            k_chain, k_noise = jax.random.split(k_chain)
            zs.append(np.array(jax.random.normal(k_noise, (BATCH, T, C))))
        steps.append(np.stack(zs))
    return torch.from_numpy(np.concatenate(prior)), torch.from_numpy(np.concatenate(steps, 1))


def calibrate_both(models, key, **kw):
    jmodel, pmodel = models
    want = jax_calibrate(jmodel, num_samples=N, num_diffusion_steps=STEPS,
                         sample_batch_size=BATCH, key=key, **kw)
    prior, steps = sampler_draws(key, N // BATCH, STEPS)
    floor_prior, floor_steps = sampler_draws(jax.random.split(key, 2)[1], N // BATCH, STEPS)
    got = calibrate_tau_0(pmodel, num_samples=N, num_diffusion_steps=STEPS,
                          sample_batch_size=BATCH, prior_noise=prior, step_noise=steps,
                          floor_prior_noise=floor_prior, floor_step_noise=floor_steps, **kw)
    assert isinstance(got, TauCalibration)
    return got, want


def _agree(got, want):
    assert got.tau_0 == want.tau_0
    assert got.cache_kwargs == want.cache_kwargs
    np.testing.assert_allclose(got.sw_noise_floor, want.sw_noise_floor, rtol=1e-3)
    assert len(got.arms) == len(want.arms)
    for a, b in zip(got.arms, want.arms):
        assert a.tau_0 == b.tau_0
        assert a.steps_skipped_ratio == b.steps_skipped_ratio
        assert (a.within_floor, a.guard_silent, a.accepted) == (b.within_floor, b.guard_silent,
                                                                 b.accepted)
        np.testing.assert_allclose(a.sw_vs_uncached, b.sw_vs_uncached, rtol=1e-3)
        np.testing.assert_allclose([a.guard_err_mean, a.guard_err_max],
                                   [b.guard_err_mean, b.guard_err_max], rtol=1e-3, atol=1e-6)


def test_calibration_matches_jax_arm_by_arm(models):
    """A ladder whose two largest arms overrun a worst-span tolerance of 2
    and whose third is accepted; the fourth is never run."""
    got, want = calibrate_both(models, jax.random.PRNGKey(21), ladder=(3.0, 1.5, 0.6, 0.2),
                               num_directions=64, guard_abs_tol=2.5, guard_max_tol=2.0,
                               cache_kwargs={"R": 10, "eps_order": 1})
    _agree(got, want)
    assert got.tau_0 == 0.6 and got.accepted is got.arms[-1] and len(got.arms) == 3
    assert got.cache_kwargs["tau_0"] == got.tau_0 and got.cache_kwargs["R"] == 10
    assert any(arm.steps_skipped_ratio > 0 for arm in got.arms)


def test_calibration_without_an_accepted_arm_matches_jax(models):
    """The JAX package's guard default is the raw ``guard_abs_tol`` (0.0),
    so an arm with any guard measurement is rejected: τ₀ None, and no
    ``tau_0`` in the recommended cache kwargs."""
    got, want = calibrate_both(models, jax.random.PRNGKey(22), ladder=(1.2, 0.5),
                               num_directions=32)
    _agree(got, want)
    assert got.tau_0 is None and got.accepted is None
    assert len(got.arms) == 2 and not any(a.accepted for a in got.arms)
    assert "tau_0" not in got.cache_kwargs and got.cache_kwargs["level"] == "score"


def test_calibration_draws_the_same_noise_for_the_pilot_and_every_arm(models):
    """Without injected noise the pilot and each arm use ``seed``'s draws and
    the floor's rerun ``seed + 1``'s: the result repeats exactly."""
    _, pmodel = models
    kw = dict(num_samples=N, num_diffusion_steps=12, sample_batch_size=BATCH, seed=5,
              ladder=(0.8,), num_directions=16, guard_abs_tol=2.5)
    a, b = calibrate_tau_0(pmodel, **kw), calibrate_tau_0(pmodel, **kw)
    assert a == b and a.sw_noise_floor > 0
    assert DEFAULT_LADDER == (1.5, 1.2, 1.0, 0.8, 0.6, 0.4)


@pytest.mark.parametrize("kw, match", [(dict(batches_per_call=2), "graph-captured"),
                                       (dict(mesh=object()), "distribution")])
def test_calibration_options_the_sampler_lacks_raise(models, kw, match):
    with pytest.raises(NotImplementedError, match=match):
        calibrate_tau_0(models[1], num_samples=N, num_diffusion_steps=4, **kw)
