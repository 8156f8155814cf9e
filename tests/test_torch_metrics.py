"""Port parity: the Wasserstein metrics (``fdtpu_torch/metrics``) against the
JAX package's on the same numpy-seeded arrays.

Time-domain values come from the same numpy code on both sides and must be
equal to 1e-12.  Frequency-domain and spectral values go through each
package's own float32 DFT, which sum in other orders: relative 1e-5.
"""

from functools import partial

import numpy as np
import pytest
import torch

from fdtpu import metrics as jm
from fdtpu.metrics import metrics as jmm
from fdtpu_torch import metrics as pm
from fdtpu_torch.metrics import metrics as pmm


def _data(n, t, c=1, seed=0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, t, c)) + shift).astype(np.float32)


@pytest.mark.parametrize("na, nb", [(20, 20), (17, 9), (1, 5)])
def test_wasserstein2_1d_matches_jax(na, nb):
    rng = np.random.default_rng(na * 100 + nb)
    a, b = rng.standard_normal(na), rng.standard_normal(nb) + 0.3
    assert pm.wasserstein2_1d(a, b) == jm.wasserstein2_1d(a, b)


@pytest.mark.parametrize("normalisation", ["none", "standardise"])
def test_wasserstein_distances_match_jax_draw_for_draw(normalisation):
    x, y = _data(30, 7, seed=1).reshape(30, 7), _data(25, 7, seed=2, shift=0.5).reshape(25, 7)
    got = pm.WassersteinDistances(x, y, normalisation=normalisation, seed=3)
    want = jm.WassersteinDistances(x, y, normalisation=normalisation, seed=3)
    np.testing.assert_array_equal(got.sliced_distances(40), want.sliced_distances(40))
    np.testing.assert_array_equal(got.marginal_distances(), want.marginal_distances())
    d = np.random.default_rng(4).standard_normal(7)
    assert got.directional_distance(d) == want.directional_distance(d)
    assert got.feature_distance(2) == want.feature_distance(2)


def test_wasserstein_rejects_an_unknown_normalisation():
    wd = pm.WassersteinDistances(np.ones((3, 2)), np.ones((3, 2)), normalisation="max")
    with pytest.raises(ValueError, match="normalisation"):
        wd.feature_distance(0)


def test_check_flat_array_takes_numpy_and_tensors():
    x = _data(4, 6, c=2)
    want = jmm.check_flat_array(x)
    for got in (pmm.check_flat_array(x), pmm.check_flat_array(torch.from_numpy(x)),
                pmm.check_flat_array(torch.from_numpy(x).requires_grad_())):
        assert got.dtype == np.float64 and got.shape == (4, 12)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pmm.check_flat_array(x[:, :, 0]),
                                  jmm.check_flat_array(x[:, :, 0]))


@pytest.mark.parametrize("save_all", [False, True])
@pytest.mark.parametrize("cls", ["SlicedWasserstein", "MarginalWasserstein"])
@pytest.mark.parametrize("t", [16, 17])
def test_single_metric_and_its_baselines_match_jax(t, cls, save_all):
    orig, other = _data(24, t, seed=5), _data(19, t, seed=6, shift=0.2)
    kw = dict(random_seed=42, save_all_distances=save_all)
    if cls == "SlicedWasserstein":
        kw["num_directions"] = 50
    got = getattr(pm, cls)(original_samples=orig, **kw)
    want = getattr(jm, cls)(original_samples=orig, **kw)
    assert got.name == want.name
    assert got(torch.from_numpy(other)) == want(other)
    assert got.baseline_metrics == want.baseline_metrics


def _collection(pkg, orig, **kw):
    return pkg.MetricCollection(
        [partial(pkg.SlicedWasserstein, random_seed=42, num_directions=60,
                 save_all_distances=True),
         partial(pkg.MarginalWasserstein, random_seed=42, save_all_distances=True)],
        original_samples=orig, **kw)


@pytest.mark.parametrize("spectral", [False, True])
@pytest.mark.parametrize("baselines", [False, True])
@pytest.mark.parametrize("t, c", [(16, 1), (17, 1), (12, 2)])
def test_metric_collection_matches_jax(t, c, baselines, spectral):
    orig, other = _data(30, t, c, seed=7), _data(22, t, c, seed=8, shift=0.3)
    kw = dict(include_baselines=baselines, include_spectral_density=spectral)
    got = _collection(pm, orig, **kw)(torch.from_numpy(other))
    want = _collection(jm, orig, **kw)(other)
    assert list(got) == list(want)
    for key, value in want.items():
        if key.startswith("time_"):
            np.testing.assert_allclose(got[key], value, rtol=1e-12, atol=0, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-7, err_msg=key)
    assert any(k.startswith("freq_") for k in got)
    assert any(k.endswith("_self") for k in got) == baselines
    assert any(k.startswith("spectral_") for k in got) == spectral


def test_metric_collection_with_a_ready_metric_matches_jax():
    """A metric passed ready-made (not a partial) has no frequency twin, so
    the reference's paired loop scores nothing: the port keeps that."""
    orig, other = _data(20, 9, seed=9), _data(20, 9, seed=10)
    outs = [pkg.MetricCollection([pkg.MarginalWasserstein(original_samples=orig, random_seed=1)],
                                 original_samples=orig, include_spectral_density=True)(other)
            for pkg in (pm, jm)]
    assert list(outs[0]) == list(outs[1]) == [
        "spectral_marginal_wasserstein_all", "spectral_marginal_wasserstein_max",
        "spectral_marginal_wasserstein_mean"]
    np.testing.assert_allclose(outs[0]["spectral_marginal_wasserstein_mean"],
                               outs[1]["spectral_marginal_wasserstein_mean"], rtol=1e-5)
