"""Each plain reference against the port at tiny sizes on the CPU."""

import numpy as np
import pytest
import torch

from portbench import program, weights
from portbench.reference import chain, model, train

MODEL = dict(backbone="transformer", n_channels=2, max_len=11, d_model=12, num_layers=2,
             n_head=3, dim_feedforward=32, dropout=0.1, gfp_scale=30.0, ln_eps=1e-5,
             attention_impl="auto", compute_dtype="float32")
SDE = dict(kind="vp", beta_min=0.1, beta_max=20.0, eps=1e-5, fourier_noise_scaling=True)
CONFIG = dict(model=MODEL, sde=SDE)


def _program(w, steps=20):
    return program.score_model(CONFIG, w, "cpu", steps)


def test_weights_cover_the_network():
    w = weights.make_weights(MODEL, 3, "cpu")
    net = _program(w).network
    assert set(w) == set(net.state_dict())
    assert all(w[k].shape == v.shape for k, v in net.state_dict().items())
    assert torch.equal(w["backbone.0.in_proj_bias"], torch.zeros(36))


@pytest.mark.parametrize("train_mode", [False, True])
def test_score_network(train_mode):
    w = weights.make_weights(MODEL, 4, "cpu")
    net = _program(w).network
    g = torch.Generator().manual_seed(0)
    x, t = torch.randn((5, 11, 2), generator=g), torch.rand((5,), generator=g)
    gen = (lambda: torch.Generator().manual_seed(9)) if train_mode else (lambda: None)
    got = net.train(train_mode)(x, t, train_mode, gen())
    want = model.score(w, MODEL, x, t, gen())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cache", [None, {"level": "score", "R": 6, "tau_0": 0.1,
                                         "eps_order": 1}])
def test_chain(cache):
    from fdtpu_torch.sampling import DiffusionSampler

    w = weights.make_weights(MODEL, 5, "cpu")
    m = _program(w, 30)
    sampler = DiffusionSampler(m, 3, use_cache=cache is not None, cache_kwargs=cache,
                               batches_per_call=2)
    g = torch.Generator().manual_seed(1)
    prior, noise = torch.randn((6, 11, 2), generator=g), torch.randn((30, 6, 11, 2), generator=g)
    got = sampler.sample(6, 30, prior_noise=prior, step_noise=noise)
    vp = model.VP(SDE, 11, "cpu")
    follow = sampler.last_modes
    ref = chain.run_call(lambda x, t: model.score(w, MODEL, x, t), vp, prior, noise, 3, cache,
                         follow)
    torch.testing.assert_close(got, ref["samples"], rtol=1e-4, atol=1e-5)
    assert ref["mismatched"] == 0
    if cache is not None:
        assert torch.equal(follow.cpu(), ref["modes"])
        assert 0 < int(ref["modes"].sum()) < ref["modes"].numel()


@pytest.mark.parametrize("t", [10, 11, 365])
def test_packed_dft(t):
    from fdtpu_torch.ops.fourier import dft

    x = np.random.default_rng(t).normal(size=(4, t, 3)).astype(np.float32)
    np.testing.assert_allclose(train.packed_dft(x), dft(torch.from_numpy(x)).numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("total", [1, 9, 40, 400])
def test_schedule(total):
    from fdtpu_torch.train import make_lr_schedule

    mine, theirs = train.schedule(1e-3, max(total, 2)), make_lr_schedule(1e-3, max(total, 2))
    for k in range(max(total, 2) + 3):
        assert mine(k) == pytest.approx(theirs(k), rel=1e-12, abs=1e-15)
