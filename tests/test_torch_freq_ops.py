"""Port parity: the spectral and FreqCa ops (``fdtpu_torch/ops/fourier.py``)
and FreSca (``fdtpu_torch/ops/fresca.py``) against the JAX package on its CPU
backend (its FFT branches), on the same numpy-seeded inputs.

Tolerances: atol 1e-5 and rtol 1e-4 for the FreqCa ops and the spectral
density (float32 transforms that sum in other orders), atol 1e-5 for FreSca,
whose energy cutoff bin must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.ops import fourier as jf
from fdtpu.ops import fresca as jfr
from fdtpu_torch.ops import fourier as pf
from fdtpu_torch.ops import fresca as pfr

TOL = dict(atol=1e-5, rtol=1e-4)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("shape", [(3, 16, 2), (3, 17, 2), (4, 187, 1)])
def test_spectral_density_matches_jax(shape):
    x = _rand(shape)
    _close(pf.spectral_density(torch.from_numpy(x)), jf.spectral_density(jnp.asarray(x)))
    packed = np.array(jf.dft(jnp.asarray(x)))
    _close(pf.spectral_density(torch.from_numpy(packed), apply_dft=False),
           jf.spectral_density(jnp.asarray(packed), apply_dft=False))


@pytest.mark.parametrize("ratio", [0.3, 0.05, 0.9])
@pytest.mark.parametrize("shape", [(3, 16, 5), (3, 17, 5), (16, 6), (17, 6), (2, 3, 11, 4)],
                         ids=["3d-even", "3d-odd", "2d-even", "2d-odd", "4d"])
@pytest.mark.parametrize("fn", ["frequency_decompose_fft", "frequency_decompose_dct"])
def test_frequency_decompose_matches_jax(fn, shape, ratio):
    x = _rand(shape, seed=1)
    if len(shape) == 4:
        # The KV level decomposes (L, T, D) histories flattened to 3-D.
        x = x.reshape(-1, *shape[-2:])
    low, high = getattr(pf, fn)(torch.from_numpy(x), ratio)
    jlow, jhigh = getattr(jf, fn)(jnp.asarray(x), ratio)
    assert low.shape == high.shape == x.shape
    _close(low, jlow)
    _close(high, jhigh)


@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
def test_hermite_polynomials_match_jax(order):
    s = np.linspace(-1, 1, 9, dtype=np.float32)
    _close(pf.hermite_polynomials(torch.from_numpy(s), order),
           jf.hermite_polynomials(jnp.asarray(s), order))
    s2 = _rand((3, 5), seed=2).clip(-1, 1)
    _close(pf.hermite_polynomials(torch.from_numpy(s2), order),
           jf.hermite_polynomials(jnp.asarray(s2), order))
    _close(pf.hermite_design_matrix(torch.from_numpy(s), order),
           jf.hermite_design_matrix(jnp.asarray(s), order))


def _ring(k=6, feat=(3, 4), seed=3):
    """A history whose entries drift smoothly in t, newest last, t falling."""
    t = np.linspace(0.9, 0.4, k).astype(np.float32)
    base = _rand((3,) + feat, seed=seed)
    hist = base[0] + base[1] * t[:, None, None] + base[2] * t[:, None, None] ** 2
    return hist.astype(np.float32), t


PREDICT_CASES = {
    "full-ring-clipped": dict(live=6, clip=True, target=0.3),
    "full-ring-extrapolated": dict(live=6, clip=False, target=0.3),
    "full-ring-inside-span": dict(live=6, clip=True, target=0.65),
    "unfilled-ring": dict(live=3, clip=True, target=0.3),
    "unfilled-ring-extrapolated": dict(live=4, clip=False, target=0.35),
    "two-live-entries": dict(live=2, clip=True, target=0.3),
    "degenerate-span": dict(live=1, clip=True, target=0.3),
    "clip-as-tensor-true": dict(live=3, clip=np.bool_(True), target=0.3),
    "clip-as-tensor-false": dict(live=5, clip=np.bool_(False), target=0.3),
}


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("name", list(PREDICT_CASES))
def test_predict_hermite_matches_jax(name, order):
    case = PREDICT_CASES[name]
    hist, t = _ring()
    k = len(t)
    valid = np.arange(k) >= k - case["live"]
    # An unfilled ring holds zeros in its dead rows.
    hist = np.where(valid[:, None, None], hist, 0.0).astype(np.float32)
    t = np.where(valid, t, 0.0).astype(np.float32)
    clip = case["clip"]
    tclip = torch.tensor(bool(clip)) if isinstance(clip, np.bool_) else clip
    jclip = jnp.asarray(bool(clip)) if isinstance(clip, np.bool_) else clip
    target = np.float32(case["target"])
    got = pf.predict_hermite(torch.from_numpy(hist), torch.from_numpy(t), torch.tensor(target),
                             order=order, valid=torch.from_numpy(valid), clip_target=tclip)
    want = jf.predict_hermite(jnp.asarray(hist), jnp.asarray(t), jnp.asarray(target),
                              order=order, valid=jnp.asarray(valid), clip_target=jclip)
    assert got.shape == hist.shape[1:]
    _close(got, want)
    if case["live"] == 1:
        np.testing.assert_array_equal(got.numpy(), hist[-1])


def test_predict_hermite_without_mask_and_short_history_match_jax():
    hist, t = _ring(k=4)
    got = pf.predict_hermite(torch.from_numpy(hist), torch.from_numpy(t), torch.tensor(0.5))
    _close(got, jf.predict_hermite(jnp.asarray(hist), jnp.asarray(t), jnp.asarray(0.5)))
    one = pf.predict_hermite(torch.from_numpy(hist[:1]), torch.from_numpy(t[:1]),
                             torch.tensor(0.5))
    np.testing.assert_array_equal(one.numpy(), hist[0])


# -------------------------------------------------------------------- FreSca
def _spectrum(n, seed):
    return np.abs(_rand((n,), seed=seed)) + 0.05


@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.5, 0.85, 1.0])
@pytest.mark.parametrize("strategy", ["spatial", "energy"])
def test_frequency_masks_match_jax(strategy, ratio):
    n = 11
    spec = _spectrum(n, 4)
    kw = dict(freq_spectrum=torch.from_numpy(spec)) if strategy == "energy" else {}
    jkw = dict(freq_spectrum=jnp.asarray(spec)) if strategy == "energy" else {}
    low, high = pfr.create_frequency_masks(n, ratio, strategy, **kw)
    jlow, jhigh = jfr.create_frequency_masks(n, ratio, strategy, **jkw)
    np.testing.assert_array_equal(low.numpy(), np.asarray(jlow))
    np.testing.assert_array_equal(high.numpy(), np.asarray(jhigh))


def test_energy_cutoff_is_zero_when_never_reached():
    """The reference's degenerate case: a ratio above 1 reaches no bin."""
    spec = torch.ones(7)
    low, _ = pfr.create_frequency_masks(7, 1.5, "energy", spec)
    jlow, _ = jfr.create_frequency_masks(7, 1.5, "energy", jnp.ones(7))
    np.testing.assert_array_equal(low.numpy(), np.asarray(jlow))
    assert low.tolist() == [1.0] + [0.0] * 6


@pytest.mark.parametrize("ratio", [0.2, 0.5, 0.8])
@pytest.mark.parametrize("strategy", ["spatial", "energy"])
@pytest.mark.parametrize("shape", [(8, 5), (9, 6), (12, 6)])
def test_frequency_masks_2d_match_jax(shape, strategy, ratio):
    spec = np.abs(_rand(shape, seed=5)) + 0.05
    kw = dict(freq_spectrum=torch.from_numpy(spec)) if strategy == "energy" else {}
    jkw = dict(freq_spectrum=jnp.asarray(spec)) if strategy == "energy" else {}
    low, high = pfr.create_frequency_masks_2d(shape, ratio, strategy, **kw)
    jlow, jhigh = jfr.create_frequency_masks_2d(shape, ratio, strategy, **jkw)
    np.testing.assert_array_equal(low.numpy(), np.asarray(jlow))
    np.testing.assert_array_equal(high.numpy(), np.asarray(jhigh))


def _energy_cutoff(x: np.ndarray, ratio: float) -> int:
    """The energy cutoff bin that the 1-D path picks for ``x``."""
    spec = torch.abs(torch.fft.rfft(torch.from_numpy(x), dim=1, norm="ortho")).mean(dim=(0, 2))
    low, _ = pfr.create_frequency_masks(spec.shape[0], ratio, "energy", spec)
    return int(low.sum()) - 1


@pytest.mark.parametrize("strategy", ["spatial", "energy"])
@pytest.mark.parametrize("shape", [(3, 16, 2), (3, 17, 2), (2, 12, 10, 3), (2, 9, 7, 1)],
                         ids=["3d-even", "3d-odd", "4d-even", "4d-odd"])
def test_frequency_scale_matches_jax(shape, strategy):
    x = _rand(shape, seed=6)
    kw = dict(low_scale=0.8, high_scale=1.7, cutoff_ratio=0.4, cutoff_strategy=strategy)
    got = pfr.frequency_scale(torch.from_numpy(x), **kw)
    want = jfr.frequency_scale(jnp.asarray(x), **kw)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if strategy == "energy" and len(shape) == 3:
        # The cutoff bin both sides picked: recover JAX's from its output.
        xf = np.fft.rfft(x, axis=1, norm="ortho")
        yf = np.fft.rfft(np.asarray(want), axis=1, norm="ortho")
        ratio = np.abs(yf).sum(axis=(0, 2)) / np.abs(xf).sum(axis=(0, 2))
        assert int(np.sum(np.isclose(ratio, 0.8, atol=1e-3))) - 1 == _energy_cutoff(x, 0.4)


@pytest.mark.parametrize("high_scale", [1.5, 0.7])
@pytest.mark.parametrize("strategy", ["spatial", "energy"])
def test_apply_fresca_to_score_with_decay_matches_jax(strategy, high_scale):
    x = _rand((4, 17, 2), seed=7)
    for t, num_steps in ((0.73, 50), (0.73, None), (None, 50), (40.0, 50)):
        kw = dict(low_scale=1.1, high_scale=high_scale, cutoff_ratio=0.5,
                  cutoff_strategy=strategy, num_steps=num_steps)
        tt = None if t is None else torch.tensor(t, dtype=torch.float32)
        got = pfr.apply_fresca_to_score(torch.from_numpy(x), timestep=tt, **kw)
        want = jfr.apply_fresca_to_score(
            jnp.asarray(x), timestep=None if t is None else jnp.float32(t), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_apply_fresca_takes_a_tensor_scale():
    x = torch.from_numpy(_rand((2, 16, 1), seed=8))
    a = pfr.apply_fresca_to_score(x, high_scale=torch.tensor(1.5), timestep=torch.tensor(0.5),
                                  num_steps=10)
    b = pfr.apply_fresca_to_score(x, high_scale=1.5, timestep=torch.tensor(0.5), num_steps=10)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("ratio", [0.25, 0.5])
@pytest.mark.parametrize("shape", [(3, 16, 2), (3, 17, 2)])
def test_analyze_frequency_content_matches_jax(shape, ratio):
    x = _rand(shape, seed=9)
    got = pfr.analyze_frequency_content(torch.from_numpy(x), ratio)
    want = jfr.analyze_frequency_content(jnp.asarray(x), ratio)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
