"""Port parity: the transformer score model, fdtpu_torch against fdtpu.

The JAX variables are carried into the port with ``load_jax_variables``;
inputs are numpy arrays from a seed.  Tolerances: atol 2e-5 on the einsum
path (as tests/test_torch_parity.py:118 holds fdtpu to torch), 1e-4 on the
block-diagonal path (as tests/test_kernels.py:145 holds fdtpu's kernel path
to its einsum path), 5e-2 for bfloat16 compute (two frameworks round bf16 at
different places; fp32 and bf16 outputs differ by ~0.3 here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.kernels import blockdiag_attention as jax_bda
from fdtpu.models import score_models as jsm
from fdtpu.models.initializers import max_norm_rows as jax_max_norm_rows
from fdtpu_torch.models import score_models as psm
from fdtpu_torch.models.initializers import max_norm_rows
from fdtpu_torch.utils.convert import load_jax_variables, state_dict_to_jax_variables
from fdtpu_torch.utils.device import resolve_device

SMALL = dict(n_channels=2, d_model=12, num_layers=2, n_head=2, dim_feedforward=24)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route the JAX model's kernel call through Pallas interpret mode, as
    tests/test_kernels.py does, so the blockdiag path runs on the CPU."""
    orig = jax_bda.blockdiag_mha

    def interp(q, k, v, q_tile=256, interpret=False, shift=True):
        return orig(q, k, v, q_tile=q_tile, interpret=True, shift=shift)

    monkeypatch.setattr(jax_bda, "blockdiag_mha", interp)


def _pair(max_len, attention_impl="einsum", compute_dtype="float32", seed=0):
    kw = dict(SMALL, max_len=max_len, attention_impl=attention_impl,
              compute_dtype=compute_dtype)
    jcfg = jsm.ScoreModelConfig(**kw)
    variables = jsm.init_score_model(jax.random.PRNGKey(seed), jcfg)
    net = psm.init_score_model(psm.ScoreModelConfig(**kw), device="cpu")
    load_jax_variables(net, jax.tree.map(np.asarray, variables))
    return jcfg, variables, net


def _xt(max_len, batch=4, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, max_len, SMALL["n_channels"])).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, batch).astype(np.float32)
    return x, t


@pytest.mark.parametrize("max_len", [16, 17])
@pytest.mark.parametrize("impl, atol", [("einsum", 2e-5), ("blockdiag", 1e-4)])
def test_score_apply_matches_jax(pallas_interpret, max_len, impl, atol):
    jcfg, variables, net = _pair(max_len, impl)
    x, t = _xt(max_len)
    want = np.asarray(jsm.score_apply(variables, jcfg, jnp.asarray(x), jnp.asarray(t)))
    got = psm.score_apply(net, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize("t_val", [1e-5, 0.5, 1.0])
def test_score_apply_matches_jax_at_extreme_timesteps(t_val):
    jcfg, variables, net = _pair(17)
    x, _ = _xt(17, seed=2)
    t = np.full((4,), t_val, np.float32)
    want = np.asarray(jsm.score_apply(variables, jcfg, jnp.asarray(x), jnp.asarray(t)))
    got = psm.score_apply(net, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("impl", ["einsum", "blockdiag"])
def test_score_apply_bf16_matches_jax_and_keeps_input_dtype(pallas_interpret, impl):
    jcfg, variables, net = _pair(16, impl, compute_dtype="bfloat16")
    x, t = _xt(16)
    want = np.asarray(jsm.score_apply(variables, jcfg, jnp.asarray(x), jnp.asarray(t)))
    got = psm.score_apply(net.compute_copy(), torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2)
    # The float32 network gives the same result (weights cast per call).
    uncast = psm.score_apply(net, torch.from_numpy(x), torch.from_numpy(t))
    torch.testing.assert_close(uncast, got, rtol=0, atol=0)


def test_blockdiag_and_einsum_paths_agree_in_the_port():
    _, variables, net = _pair(17, "blockdiag")
    _, _, net_einsum = _pair(17, "einsum")
    x, t = _xt(17, seed=3)
    a = psm.score_apply(net, torch.from_numpy(x), torch.from_numpy(t))
    b = psm.score_apply(net_einsum, torch.from_numpy(x), torch.from_numpy(t))
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_loaded_network_matches_jax_parameter_count_and_structure():
    jcfg, variables, net = _pair(16)
    assert psm.param_count(net) == jsm.param_count(variables)
    assert sum(b.numel() for b in net.buffers()) == variables["constants"]["time_encoder"]["W"].size
    fresh = psm.init_score_model(psm.ScoreModelConfig(**SMALL, max_len=16), device="cpu")
    assert {k: v.shape for k, v in fresh.state_dict().items()} == {
        k: v.shape for k, v in net.state_dict().items()
    }


def test_init_is_seeded_and_torch_default_distributed():
    cfg = psm.ScoreModelConfig(**SMALL, max_len=16)
    a = psm.init_score_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = psm.init_score_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    layer = a.backbone[0]
    bound = (6.0 / (4 * cfg.d_model)) ** 0.5
    assert layer.in_proj_weight.abs().max() <= bound
    assert float(layer.in_proj_bias.abs().max()) == 0.0
    assert float(layer.out_proj.bias.abs().max()) == 0.0
    assert layer.linear2.weight.abs().max() <= cfg.dim_feedforward ** -0.5
    assert not any(p.requires_grad for p in a.parameters())


def test_score_model_config_mirrors_jax_fields_and_defaults():
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert fields(psm.ScoreModelConfig) == fields(jsm.ScoreModelConfig)
    cfg = psm.ScoreModelConfig(n_channels=1, max_len=187)
    assert (cfg.d_model, cfg.num_layers, cfg.n_head, cfg.head_dim) == (72, 10, 12, 6)


def test_score_model_bundle_calls_the_network():
    jcfg, variables, net = _pair(16)
    from fdtpu_torch.diffusion import VPScheduler

    model = psm.ScoreModel(config=net.config, network=net, scheduler=VPScheduler())
    x, t = _xt(16)
    torch.testing.assert_close(
        model(torch.from_numpy(x), torch.from_numpy(t)),
        psm.score_apply(net, torch.from_numpy(x), torch.from_numpy(t)),
    )
    assert model.param_count() == jsm.param_count(variables)
    assert (model.n_channels, model.max_len) == (2, 16)


def test_wrong_input_shape_raises():
    _, _, net = _pair(16)
    with pytest.raises(ValueError, match="wrong shape"):
        net(torch.zeros(4, 17, 2), torch.zeros(4))


def test_resolve_attention_impl():
    """``auto`` takes the kernels on CUDA at every head_dim they take (the
    H100's crossover, PERF.md §6), einsum past 32 and on the CPU."""
    assert psm.resolve_attention_impl("einsum", 6) == "einsum"
    assert psm.resolve_attention_impl("blockdiag", 32) == "blockdiag"
    assert psm.resolve_attention_impl("auto", 6, "cpu") == "einsum"
    assert psm.resolve_attention_impl("auto", 6, "cuda") == "blockdiag"
    assert psm.resolve_attention_impl("auto", 16, "cuda") == "blockdiag"
    assert psm.resolve_attention_impl("auto", 32, "cuda") == "blockdiag"
    assert psm.resolve_attention_impl("auto", 33, "cuda") == "einsum"


def test_unported_backbones_raise_not_implemented():
    """Every backbone of the JAX package is ported, and the port adds DiT's;
    a backbone neither has is refused by name."""
    for backbone, cls in (("transformer", psm.ScoreNetwork), ("mlp", psm.MLPScoreNetwork),
                          ("lstm", psm.LSTMScoreNetwork), ("dit", psm.DiTScoreNetwork)):
        cfg = psm.ScoreModelConfig(**SMALL, max_len=16, backbone=backbone)
        assert type(psm.init_score_model(cfg, device="cpu")) is cls
    cfg = psm.ScoreModelConfig(**SMALL, max_len=16, backbone="gru")
    with pytest.raises(ValueError, match="transformer, mlp, lstm or dit"):
        psm.init_score_model(cfg, device="cpu")


# The MLP and LSTM backbones (fdtpu/models/score_models.py:276-341): the same
# tolerance as the einsum transformer (atol 2e-5).
@pytest.mark.parametrize("backbone", ["mlp", "lstm"])
@pytest.mark.parametrize("max_len", [16, 17])
@pytest.mark.parametrize("compute_dtype, atol", [("float32", 2e-5), ("bfloat16", 5e-2)])
def test_mlp_and_lstm_score_apply_match_jax(backbone, max_len, compute_dtype, atol):
    kw = dict(SMALL, max_len=max_len, backbone=backbone, d_mlp=20, compute_dtype=compute_dtype)
    jcfg = jsm.ScoreModelConfig(**kw)
    variables = jax.tree.map(np.asarray, jsm.init_score_model(jax.random.PRNGKey(5), jcfg))
    net = psm.init_score_model(psm.ScoreModelConfig(**kw), device="cpu")
    load_jax_variables(net, variables)
    assert psm.param_count(net) == jsm.param_count(variables)
    x, t = _xt(max_len, seed=6)
    want = np.asarray(jsm.score_apply(variables, jcfg, jnp.asarray(x), jnp.asarray(t)))
    got = psm.score_apply(net.compute_copy(), torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


@pytest.mark.parametrize("backbone", ["transformer", "mlp", "lstm"])
def test_conversion_round_trips_both_ways(backbone):
    kw = dict(SMALL, max_len=16, backbone=backbone, d_mlp=20)
    variables = jax.tree.map(np.asarray, jsm.init_score_model(jax.random.PRNGKey(7),
                                                              jsm.ScoreModelConfig(**kw)))
    net = psm.init_score_model(psm.ScoreModelConfig(**kw), device="cpu")
    back = state_dict_to_jax_variables(load_jax_variables(net, variables).state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(got, want)
    if backbone == "lstm":
        # x @ w in JAX, w @ x in torch, gates (i, f, g, o) kept in order.
        np.testing.assert_array_equal(net.backbone[1].w_hh.numpy(),
                                      variables["params"]["backbone"]["w_hh"][1].T)


def test_mlp_dropout_draws_two_masks_a_block_from_the_generator():
    cfg = psm.ScoreModelConfig(**dict(SMALL, max_len=16, backbone="mlp", d_mlp=20))
    net = psm.init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    x, t = (torch.from_numpy(a) for a in _xt(16))
    g = torch.Generator().manual_seed(1)
    first = net(x, t, train=True, generator=g)
    assert g.initial_seed() == 1 and not torch.equal(first, net(x, t))
    torch.testing.assert_close(net(x, t, train=True, generator=torch.Generator().manual_seed(1)),
                               first, rtol=0, atol=0)
    torch.testing.assert_close(net(x, t, train=True), net(x, t), rtol=0, atol=0)
    # Two (B, d_mlp) and (B, d_model) masks a block, in order: the generator
    # has advanced by their uniforms.
    ref = torch.Generator().manual_seed(1)
    for _ in range(cfg.num_layers):
        torch.rand((4, cfg.d_mlp), generator=ref)
        torch.rand((4, cfg.d_model), generator=ref)
    torch.testing.assert_close(torch.rand(3, generator=g), torch.rand(3, generator=ref))


@pytest.mark.parametrize("backbone", ["mlp", "lstm"])
def test_token_and_kv_levels_are_transformer_only(backbone):
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.sampling import DiffusionSampler

    cfg = psm.ScoreModelConfig(**dict(SMALL, max_len=16, backbone=backbone, d_mlp=20))
    net = psm.init_score_model(cfg, device="cpu")
    model = psm.ScoreModel(config=cfg, network=net, scheduler=VPScheduler())
    for level in ("token", "kv"):
        sampler = DiffusionSampler(model, 4, use_cache=True,
                                   cache_kwargs={"level": level, "token_budget": 4})
        with pytest.raises(ValueError, match="transformer backbone"):
            sampler.sample(4, 3, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="transformer backbone"):
        psm.score_apply_cached(net, torch.zeros(2, 16, 2), torch.ones(2), (None, None), None, 0)
    samples = DiffusionSampler(model, 4, use_cache=True, cache_kwargs={"level": "score"}).sample(
        4, 6, generator=torch.Generator().manual_seed(0))
    assert samples.shape == (4, 16, 2) and bool(torch.isfinite(samples).all())


def test_max_norm_rows_matches_jax_and_leaves_the_table():
    table = np.random.default_rng(4).standard_normal((17, 12)).astype(np.float32) * 3
    t = torch.from_numpy(table.copy())
    got = max_norm_rows(t, 12 ** 0.5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_max_norm_rows(jnp.asarray(table), 12 ** 0.5)), atol=1e-6
    )
    np.testing.assert_array_equal(t.numpy(), table)


def test_default_device_is_cuda_and_never_falls_back():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            psm.init_score_model(psm.ScoreModelConfig(**SMALL, max_len=16))
