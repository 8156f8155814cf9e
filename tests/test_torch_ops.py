"""Port parity: spectral ops and SDE schedulers, fdtpu_torch against fdtpu.

Both packages get the same numpy inputs; JAX runs on the CPU (its ``jnp.fft``
path), the port on CPU tensors.  Tolerance atol 1e-6 (float32 FFT and
elementwise math in two libraries: last-place differences only); the time
grid exact at the chain-test lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.diffusion import sde as jsde
from fdtpu.ops import fourier as jfourier
from fdtpu_torch.diffusion import sde as psde
from fdtpu_torch.ops import fourier as pfourier

LENGTHS = [16, 17]


def _x(max_len, seed=0, channels=3):
    return np.random.default_rng(seed).standard_normal((4, max_len, channels)).astype(np.float32)


@pytest.mark.parametrize("max_len", LENGTHS)
def test_packed_freq_index_matches_jax(max_len):
    assert pfourier.n_real_components(max_len) == jfourier.n_real_components(max_len)
    np.testing.assert_array_equal(
        pfourier.packed_freq_index(max_len).numpy(),
        np.asarray(jfourier.packed_freq_index(max_len)),
    )


@pytest.mark.parametrize("max_len", LENGTHS)
def test_dft_matches_jax(max_len):
    x = _x(max_len)
    want = np.asarray(jfourier.dft(jnp.asarray(x), impl="fft"))
    got = pfourier.dft(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("max_len", LENGTHS)
def test_idft_matches_jax_and_inverts(max_len):
    x = _x(max_len, seed=1)
    want = np.asarray(jfourier.idft(jnp.asarray(x), impl="fft"))
    got = pfourier.idft(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    roundtrip = pfourier.idft(pfourier.dft(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(roundtrip, x, atol=1e-5)


@pytest.mark.parametrize("fourier", [True, False])
@pytest.mark.parametrize("max_len", LENGTHS)
def test_noise_scaling_vector_matches_jax(max_len, fourier):
    np.testing.assert_array_equal(
        psde.noise_scaling_vector(max_len, fourier).numpy(),
        np.asarray(jsde.noise_scaling_vector(max_len, fourier)),
    )


@pytest.mark.parametrize("num_steps", [2, 20, 40, 100])
def test_timesteps_grid_is_exactly_jax(num_steps):
    """The grid the chain tests run on: equal to jnp.linspace bit for bit."""
    ts_j, dt_j = jsde.VPScheduler().timesteps(num_steps)
    ts_p, dt_p = psde.VPScheduler().timesteps(num_steps)
    assert ts_p.dtype == torch.float32
    np.testing.assert_array_equal(ts_p.numpy(), np.asarray(ts_j))
    assert dt_p.item() == float(dt_j)


@pytest.mark.parametrize("num_steps", [250, 1000])
def test_timesteps_grid_at_serving_lengths(num_steps):
    """At long grids XLA's CPU code for ``start·(1−s) + stop·s`` contracts
    ``1 − s`` into a fused multiply-add inside its vectorized loop; the port
    rounds each operation as the program is written.  The two differ by at
    most the rounding of ``1 − s``, half an ulp of 1.0 (5.96e-8), and the
    step size agrees exactly."""
    ts_j, dt_j = jsde.VPScheduler().timesteps(num_steps)
    ts_p, dt_p = psde.VPScheduler().timesteps(num_steps)
    diff = np.abs(ts_p.numpy() - np.asarray(ts_j))
    assert diff.max() <= np.spacing(np.float32(1.0)) / 2
    assert dt_p.item() == float(dt_j)


def _schedulers(max_len):
    return [
        (jsde.VPScheduler(fourier_noise_scaling=True).with_noise_scaling(max_len),
         psde.VPScheduler(fourier_noise_scaling=True).with_noise_scaling(max_len, "cpu")),
        (jsde.VEScheduler(fourier_noise_scaling=True).with_noise_scaling(max_len),
         psde.VEScheduler(fourier_noise_scaling=True).with_noise_scaling(max_len, "cpu")),
    ]


@pytest.mark.parametrize("kind", [0, 1], ids=["vp", "ve"])
@pytest.mark.parametrize("max_len", LENGTHS)
def test_marginal_prob_matches_jax(max_len, kind):
    js, ps = _schedulers(max_len)[kind]
    x = _x(max_len, seed=2, channels=2)
    t = np.array([1e-5, 0.3, 0.7, 1.0], np.float32)
    mean_j, std_j = js.marginal_prob(jnp.asarray(x), jnp.asarray(t))
    mean_p, std_p = ps.marginal_prob(torch.from_numpy(x), torch.from_numpy(t))
    scale = max(1.0, float(np.abs(np.asarray(std_j)).max()))
    np.testing.assert_allclose(mean_p.numpy(), np.asarray(mean_j), atol=1e-6)
    np.testing.assert_allclose(std_p.numpy(), np.asarray(std_j), atol=1e-6 * scale)


@pytest.mark.parametrize("kind", [0, 1], ids=["vp", "ve"])
@pytest.mark.parametrize("t_val", [1.0, 0.5, 1e-5])
def test_step_matches_jax(kind, t_val):
    max_len = 17
    js, ps = _schedulers(max_len)[kind]
    x, score, z = (_x(max_len, seed=s, channels=2) for s in (4, 5, 6))
    _, dt_j = js.timesteps(20)
    _, dt_p = ps.timesteps(20)
    t = np.float32(t_val)
    want = np.asarray(js.step(jnp.asarray(score), jnp.asarray(t), jnp.asarray(x),
                              jnp.asarray(z), dt_j))
    got = ps.step(torch.from_numpy(score), torch.tensor(t), torch.from_numpy(x),
                  torch.from_numpy(z), dt_p).numpy()
    # VE diffusion reaches σ_max·√(2 ln(σ_max/σ_min)) ≈ 206: scale the atol.
    np.testing.assert_allclose(got, want, atol=1e-6 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("kind", [0, 1], ids=["vp", "ve"])
def test_prior_sampling_scales_injected_noise_like_jax(kind):
    max_len = 16
    js, ps = _schedulers(max_len)[kind]
    key = jax.random.PRNGKey(3)
    shape = (4, max_len, 2)
    want = np.asarray(js.prior_sampling(key, shape))
    z = np.array(jax.random.normal(key, shape))
    got = ps.prior_sampling(shape, noise=torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_prior_sampling_draws_from_the_generator():
    ps = psde.VPScheduler(fourier_noise_scaling=True).with_noise_scaling(16, "cpu")
    a = ps.prior_sampling((4, 16, 1), torch.Generator().manual_seed(5))
    b = ps.prior_sampling((4, 16, 1), torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (4, 16, 1) and a.device.type == "cpu"
