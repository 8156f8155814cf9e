"""Card-only tests of the port's CUDA kernels (forward B1, backward B2,
token-major attention B4) and of the autograd Function over B1 and B2 (B3),
held against their plain PyTorch versions on the card, and of a token-level
and a KV-level chain through them.  They skip without a CUDA device.

This file imports only torch and the port, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: atol 2e-4 in float32 (the bound tests/test_kernels.py holds the
Pallas kernel to), 5e-2 for bfloat16 inputs against the float32 plain version.
B4 in bfloat16 against the plain version of the same bfloat16 inputs: both
round the output's float32 sum to bf16, and sums in another order may round
one bf16 ulp apart (rtol 2^-7); both also round the weights to bf16 from
float32 values a few float32 ulps apart (exp2 against exp, a reciprocal
against a division), so now and then a weight w rounds one bf16 ulp apart and
moves its output by ~2^-8 w |v| (atol 8e-3, four times the largest such
reading on the H100, as in chip_smoke.py).
"""

import pytest
import torch

from fdtpu_torch.kernels import attention as mha
from fdtpu_torch.kernels import blockdiag_attention as bda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, b, t, h, dh):
    return (
        torch.randn((b, t, h * dh), generator=gen, device="cuda"),
        torch.randn((b, h, dh, t), generator=gen, device="cuda"),
        torch.randn((b, h, t, dh), generator=gen, device="cuda"),
    )


@pytest.mark.parametrize("shape", [(128, 187, 12, 6), (4, 20, 3, 6), (2, 1024, 4, 8),
                                   (3, 33, 2, 16), (2, 70, 1, 32), (16, 501, 12, 6)])
@pytest.mark.parametrize("shift", [True, False])
def test_kernel_matches_plain_float32(cuda, shape, shift):
    q, k, v = _inputs(cuda, *shape)
    before = bda.launches
    out = bda.blockdiag_mha(q, k, v, shift=shift)
    torch.cuda.synchronize()
    assert bda.launches == before + 1
    torch.testing.assert_close(out, bda.blockdiag_mha_plain(q, k, v, shift), rtol=0, atol=2e-4)


def test_kernel_bf16_against_float32_plain(cuda):
    q, k, v = _inputs(cuda, 128, 187, 12, 6)
    out = bda.blockdiag_mha(*(a.bfloat16() for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), bda.blockdiag_mha_plain(q, k, v), rtol=0, atol=5e-2)


def test_kernel_all_underflow_is_the_true_average(cuda):
    b, t, h, dh = 2, 20, 3, 6
    q = torch.full((b, t, h * dh), 50.0, device="cuda")
    k = torch.full((b, h, dh, t), -50.0, device="cuda")
    v = torch.randn((b, h, t, dh), generator=cuda, device="cuda")
    out = bda.blockdiag_mha(q, k, v)
    want = v.mean(dim=2)[:, None].expand(b, t, h, dh).reshape(b, t, h * dh)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)


def test_kernel_raises_instead_of_falling_back(cuda):
    q, k, v = _inputs(cuda, 2, 16, 2, 6)
    with pytest.raises(TypeError):
        bda.blockdiag_mha(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        bda.blockdiag_mha(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)
    with pytest.raises(ValueError, match="head_dim"):
        bda.blockdiag_mha(*_inputs(cuda, 1, 8, 1, 40))
    # The forward kernel records no gradient; the autograd Function gives one.
    with pytest.raises(NotImplementedError, match="blockdiag_mha_trainable"):
        bda.blockdiag_mha(q.requires_grad_(), k, v)
    out = bda.blockdiag_mha_trainable(q, k, v)
    (dq,) = torch.autograd.grad(out.square().sum(), (q,))
    assert dq.shape == q.shape and bool(torch.isfinite(dq).all())


BWD_SHAPES = [(128, 187, 12, 6), (4, 20, 3, 6), (2, 1024, 4, 8), (3, 33, 2, 16), (2, 70, 1, 32),
              (16, 501, 12, 6), (64, 187, 12, 6)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_bwd_kernel_matches_plain_float32(cuda, shape):
    q, k, v = _inputs(cuda, *shape)
    g = torch.randn(q.shape, generator=cuda, device="cuda")
    before = bda.launches_bwd
    got = bda.blockdiag_mha_bwd(q, k, v, g)
    torch.cuda.synchronize()
    assert bda.launches_bwd == before + 1
    for a, b in zip(got, bda.blockdiag_mha_bwd_plain(q, k, v, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-4)


def test_bwd_kernel_bf16_against_float32_plain(cuda):
    q, k, v = _inputs(cuda, 64, 187, 12, 6)
    g = torch.randn(q.shape, generator=cuda, device="cuda")
    got = bda.blockdiag_mha_bwd(*(a.bfloat16() for a in (q, k, v, g)))
    for a, b in zip(got, bda.blockdiag_mha_bwd_plain(q, k, v, g)):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b, rtol=0, atol=5e-2)


def test_trainable_gradients_match_autograd_through_plain(cuda):
    q, k, v = (a.requires_grad_() for a in _inputs(cuda, 8, 187, 12, 6))
    g = torch.randn(q.shape, generator=cuda, device="cuda")
    before = bda.launches_trainable
    got = torch.autograd.grad(bda.blockdiag_mha_trainable(q, k, v), (q, k, v), g)
    assert bda.launches_trainable == before + 1
    want = torch.autograd.grad(bda.blockdiag_mha_plain(q, k, v), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-4)


def test_bwd_kernel_raises_instead_of_falling_back(cuda):
    q, k, v = _inputs(cuda, 2, 16, 2, 6)
    g = torch.randn(q.shape, generator=cuda, device="cuda")
    with pytest.raises(TypeError):
        bda.blockdiag_mha_bwd(q.double(), k.double(), v.double(), g.double())
    with pytest.raises(ValueError, match="contiguous"):
        bda.blockdiag_mha_bwd(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, g)
    with pytest.raises(ValueError, match="contiguous"):
        bda.blockdiag_mha_bwd(q, k, v, g.transpose(0, 1).contiguous().transpose(0, 1))
    q, k, v = _inputs(cuda, 1, 8, 1, 40)
    with pytest.raises(ValueError, match="head_dim"):
        bda.blockdiag_mha_bwd(q, k, v, torch.zeros_like(q))


# T at the edges of the B1/B2 designs: chunks of 8 keys (31, 33); row tiles of
# 2 x threads rows, threads a multiple of 32 up to 256 (64/65, 192/193, 512/513);
# key tiles of 256 records at Dh <= 8, 128 at Dh 16, 64 at Dh 32 (64/65, 128/129,
# 256/257).
EDGE_T = [1, 31, 33, 64, 65, 128, 129, 192, 193, 256, 257, 512, 513]


@pytest.mark.parametrize("t", EDGE_T)
@pytest.mark.parametrize("dh", [6, 16, 32])
def test_kernels_at_tile_edges(cuda, t, dh):
    q, k, v = _inputs(cuda, 2, t, 2, dh)
    g = torch.randn(q.shape, generator=cuda, device="cuda")
    for shift in (True, False):
        torch.testing.assert_close(bda.blockdiag_mha(q, k, v, shift=shift),
                                   bda.blockdiag_mha_plain(q, k, v, shift), rtol=0, atol=2e-4)
    for a, b in zip(bda.blockdiag_mha_bwd(q, k, v, g), bda.blockdiag_mha_bwd_plain(q, k, v, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-4)


# B 1 and H 1: one block, fewer than the card's SMs; the earlier kernels' T
# ceiling (2 x 4 x Dh x T bytes <= 232,448) at Dh 6, 32 and 1; B2's row
# statistics at the last T they fit in shared memory and the first they do not.
@pytest.mark.parametrize("shape", [(1, 187, 1, 6), (1, 4842, 1, 6), (1, 908, 2, 32),
                                   (1, 29056, 1, 1), (1, 16640, 1, 6), (1, 16641, 1, 6)])
def test_kernels_at_one_block_and_the_ceilings(cuda, shape):
    q, k, v = _inputs(cuda, *shape)
    g = torch.randn(q.shape, generator=cuda, device="cuda")
    torch.testing.assert_close(bda.blockdiag_mha(q, k, v), bda.blockdiag_mha_plain(q, k, v),
                               rtol=0, atol=2e-4)
    for a, b in zip(bda.blockdiag_mha_bwd(q, k, v, g), bda.blockdiag_mha_bwd_plain(q, k, v, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-4)


@pytest.mark.parametrize("kind", ["negative", "underflow"])
@pytest.mark.parametrize("shift", [True, False])
def test_kernel_special_rows_at_the_flagship(cuda, kind, shift):
    b, t, h, dh = 128, 187, 12, 6
    a = {"negative": 3.0, "underflow": 50.0}[kind]
    q = torch.full((b, t, h * dh), a, device="cuda")
    k = torch.full((b, h, dh, t), -a, device="cuda")
    v = torch.randn((b, h, t, dh), generator=cuda, device="cuda")
    out = bda.blockdiag_mha(q, k, v, shift=shift)
    torch.testing.assert_close(out, bda.blockdiag_mha_plain(q, k, v, shift), rtol=0, atol=2e-4)


@pytest.mark.parametrize("shape", [(64, 187, 12, 6), (1, 700, 2, 6)])
def test_bwd_kernel_is_deterministic(cuda, shape):
    q, k, v = _inputs(cuda, *shape)
    g = torch.randn(q.shape, generator=cuda, device="cuda")
    first = bda.blockdiag_mha_bwd(q, k, v, g)
    second = bda.blockdiag_mha_bwd(q, k, v, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(128, 187, 12, 6), (64, 187, 12, 6)])
def test_kernels_bf16_at_the_main_shapes(cuda, shape):
    q, k, v = _inputs(cuda, *shape)
    g = torch.randn(q.shape, generator=cuda, device="cuda")
    low = [a.bfloat16() for a in (q, k, v, g)]
    out = bda.blockdiag_mha(*low[:3])
    torch.testing.assert_close(out.float(), bda.blockdiag_mha_plain(q, k, v), rtol=0, atol=5e-2)
    for a, b in zip(bda.blockdiag_mha_bwd(*low), bda.blockdiag_mha_bwd_plain(q, k, v, g)):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b, rtol=0, atol=5e-2)


MHA_SHAPES = [(128, 24, 187, 12, 6), (128, 187, 187, 12, 6), (16, 501, 501, 12, 6),
              (3, 5, 40, 2, 6), (2, 64, 1024, 4, 8), (2, 33, 17, 3, 16), (1, 7, 9, 2, 32)]


def _mha_inputs(gen, b, tq, tk, h, dh):
    return (torch.randn((b, tq, h, dh), generator=gen, device="cuda"),
            torch.randn((b, tk, h, dh), generator=gen, device="cuda"),
            torch.randn((b, tk, h, dh), generator=gen, device="cuda"))


def _assert_mha_matches_plain(q, k, v):
    """B4 in float32 against the plain version; in bfloat16 against the plain
    version of the same bf16 inputs and of the unrounded float32 ones."""
    torch.testing.assert_close(mha.fused_mha(q, k, v), mha.mha_plain(q, k, v), rtol=0, atol=2e-4)
    low = [a.bfloat16() for a in (q, k, v)]
    out = mha.fused_mha(*low)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), mha.mha_plain(*low).float(), rtol=2 ** -7, atol=8e-3)
    torch.testing.assert_close(out.float(), mha.mha_plain(q, k, v), rtol=0, atol=5e-2)


@pytest.mark.parametrize("shape", MHA_SHAPES)
def test_mha_kernel_matches_plain_float32(cuda, shape):
    q, k, v = _mha_inputs(cuda, *shape)
    before = mha.launches
    out = mha.fused_mha(q, k, v)
    torch.cuda.synchronize()
    assert mha.launches == before + 1
    torch.testing.assert_close(out, mha.mha_plain(q, k, v), rtol=0, atol=2e-4)


@pytest.mark.parametrize("shape", MHA_SHAPES)
def test_mha_kernel_bf16_against_float32_plain(cuda, shape):
    """bf16 against the plain version of the unrounded float32 inputs and of
    the same bf16 inputs (and float32 against the plain version)."""
    _assert_mha_matches_plain(*_mha_inputs(cuda, *shape))


def test_mha_kernel_raises_instead_of_falling_back(cuda):
    q, k, v = _mha_inputs(cuda, 2, 4, 16, 2, 6)
    with pytest.raises(TypeError):
        mha.fused_mha(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        mha.fused_mha(q, k.transpose(0, 1).contiguous().transpose(0, 1), v)
    with pytest.raises(ValueError, match="head_dim"):
        mha.fused_mha(*_mha_inputs(cuda, 1, 4, 8, 1, 40))
    with pytest.raises(ValueError, match=f"Tk <= {mha.MAX_SEQ}"):
        mha.fused_mha(*_mha_inputs(cuda, 1, 4, mha.MAX_SEQ + 1, 1, 6))
    with pytest.raises(NotImplementedError, match="no gradient"):
        mha.fused_mha(q.requires_grad_(), k, v)


# Tk at the edges of B4's designs: float32 chunks of 8 keys and key tiles of 256
# records at Dh <= 8 (31-33, 255-257, 511-513); bfloat16 score tiles of 8 keys,
# one register tile up to 192 keys, two passes over tiles of 256 past it
# (191-193, 255-257, 511-513).  Tq at one row, the token level's 24 (one row a
# thread, 16-row warps) and 187.
@pytest.mark.parametrize("tk", [1, 31, 32, 33, 191, 192, 193, 255, 256, 257, 511, 512, 513])
@pytest.mark.parametrize("tq", [1, 24, 187])
def test_mha_kernel_at_tile_and_warp_edges(cuda, tq, tk):
    _assert_mha_matches_plain(*_mha_inputs(cuda, 2, tq, tk, 3, 6))


@pytest.mark.parametrize("dh", [1, 6, 8, 16, 32])
@pytest.mark.parametrize("tq, tk", [(40, 7), (7, 300), (300, 40)])
def test_mha_kernel_rectangular_at_every_width(cuda, dh, tq, tk):
    _assert_mha_matches_plain(*_mha_inputs(cuda, 3, tq, tk, 5, dh))


def test_mha_kernel_past_the_earlier_shared_memory_limit(cuda):
    """Tk = 5000 raised "shared memory" in the first design; the keys now
    stream through shared memory."""
    _assert_mha_matches_plain(*_mha_inputs(cuda, 2, 24, 5000, 3, 6))


@pytest.mark.parametrize("kind", ["negative", "underflow"])
@pytest.mark.parametrize("tq", [24, 187])
def test_mha_kernel_special_rows(cuda, kind, tq):
    """Rows of large negative scores, and rows whose every score underflows
    exp: the shifted softmax is the average of v."""
    b, tk, h, dh = 8, 187, 12, 6
    a = {"negative": 3.0, "underflow": 50.0}[kind]
    q = torch.full((b, tq, h, dh), a, device="cuda")
    k = torch.full((b, tk, h, dh), -a, device="cuda")
    v = torch.randn((b, tk, h, dh), generator=cuda, device="cuda")
    _assert_mha_matches_plain(q, k, v)
    want = v.mean(dim=1, keepdim=True).expand(b, tq, h, dh)
    torch.testing.assert_close(mha.fused_mha(q, k, v), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 24, 187, 12, 6), (128, 187, 187, 12, 6),
                                   (2, 187, 700, 3, 32)])
def test_mha_kernel_is_deterministic(cuda, dtype, shape):
    q, k, v = (a.to(dtype) for a in _mha_inputs(cuda, *shape))
    assert torch.equal(mha.fused_mha(q, k, v), mha.fused_mha(q, k, v))


def test_topk_rows_on_the_card_keep_the_cpu_tie_order(cuda):
    """Ties at the token budget's edge (the anchor and probe bonuses) are
    broken by index on the card as on the CPU."""
    from fdtpu_torch.sampling import sampler as psampler

    g = torch.Generator().manual_seed(5)
    choices = torch.tensor([0.0, 0.7, 1e9, 2e9, 5.0])
    for n, budget in ((17, 4), (187, 24), (501, 60)):
        priority = choices[torch.randint(0, 5, (n,), generator=g)]
        want = psampler._topk_rows(priority, budget)
        got = psampler._topk_rows(priority.cuda(), budget).cpu()
        assert got.tolist() == want.tolist()


@pytest.mark.parametrize("cache_kwargs", [
    dict(level="token", token_budget=4, tau_0=0.0, R=8, guard="off"),
    dict(level="kv", policy="event", K=1, R=6, tau_0=1.0, tau_warn=1e9),
], ids=["token", "kv-event"])
def test_cached_chain_on_the_card_counts_its_kernels(cuda, cache_kwargs):
    """A small model's cached chain on the card: B1 once per layer and FULL
    step, B4 once per layer and TOPK / MIXED / CACHED step; the same samples
    as the CPU chain given the same noise and probe uniforms.  VE, not VP:
    the VP std at the last step, sqrt(1 - exp(-1e-6)), cancels, so the
    card's and the CPU's exp put ~3% between the two last scores of a cached
    chain (-eps/std), which is not what this test is about."""
    from fdtpu_torch.diffusion import VEScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
    from fdtpu_torch.sampling import DiffusionSampler

    cfg = ScoreModelConfig(n_channels=2, max_len=17, d_model=12, num_layers=2, n_head=2,
                           dim_feedforward=24, attention_impl="blockdiag")
    n, batch = 30, 4
    g = torch.Generator().manual_seed(3)
    prior = torch.randn((batch, 17, 2), generator=g)
    steps = torch.randn((n, batch, 17, 2), generator=g)
    probes = torch.rand((1, n, 17), generator=g)
    samples, stats = {}, {}
    for dev in ("cuda", "cpu"):
        net = init_score_model(cfg, torch.Generator().manual_seed(0), device=dev)
        model = ScoreModel(config=cfg, network=net, scheduler=VEScheduler(sigma_max=2.0))
        sampler = DiffusionSampler(model, batch, use_cache=True, cache_kwargs=cache_kwargs)
        bda.launches = mha.launches = 0
        samples[dev] = sampler.sample(batch, n, prior_noise=prior, step_noise=steps,
                                      probe_noise=probes).cpu()
        stats[dev] = sampler.get_cache_stats()
        if dev == "cuda":
            counts = (bda.launches, mha.launches)
    s = stats["cuda"]
    b4_steps = s["mixed_steps"] + (s["cached_steps"] if cache_kwargs["level"] == "kv" else 0)
    assert counts == (cfg.num_layers * s["full_steps"], cfg.num_layers * b4_steps)
    assert counts[1] > 0
    for key in ("full_steps", "mixed_steps", "cached_steps", "recompute_count"):
        assert s[key] == stats["cpu"][key], key
    torch.testing.assert_close(samples["cuda"], samples["cpu"], rtol=0, atol=1e-4)


# ------------------------------------------------ FreSca and FreqCa on the card
@pytest.mark.parametrize("strategy", ["energy", "spatial"])
@pytest.mark.parametrize("shape", [(128, 187, 1), (4, 17, 2), (2, 12, 10, 3)])
def test_fresca_on_the_card_matches_the_cpu(cuda, shape, strategy):
    """FreSca through cuFFT against the CPU's FFT: atol 1e-5 (float32
    transforms that sum in other orders) and the same energy cutoff bin."""
    from fdtpu_torch.ops import fresca

    x = torch.randn(shape, generator=cuda, device="cuda")
    kw = dict(low_scale=0.9, high_scale=1.5, cutoff_ratio=0.5, cutoff_strategy=strategy)
    got = fresca.frequency_scale(x, **kw)
    torch.testing.assert_close(got.cpu(), fresca.frequency_scale(x.cpu(), **kw), rtol=0,
                               atol=1e-5)
    t = torch.full((), 0.37, device="cuda")
    got = fresca.apply_fresca_to_score(x, 1.0, 1.5, 0.5, strategy, timestep=t, num_steps=50)
    want = fresca.apply_fresca_to_score(x.cpu(), 1.0, 1.5, 0.5, strategy, timestep=t.cpu(),
                                        num_steps=50)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    if len(shape) == 3:
        spec = torch.abs(torch.fft.rfft(x, dim=1, norm="ortho")).mean(dim=(0, 2))
        low, _ = fresca.create_frequency_masks(spec.shape[0], 0.5, "energy", spec)
        low_cpu, _ = fresca.create_frequency_masks(spec.shape[0], 0.5, "energy", spec.cpu())
        assert int(low.sum()) == int(low_cpu.sum())


@pytest.mark.parametrize("live, clip", [(10, False), (10, True), (3, True), (1, True)])
def test_predict_hermite_on_the_card_matches_the_cpu(cuda, live, clip):
    from fdtpu_torch.ops import predict_hermite

    k = 10
    t = torch.linspace(0.9, 0.3, k, device="cuda")
    hist = torch.randn((k, 128, 187, 1), generator=cuda, device="cuda") * 0.1
    hist = hist + torch.sin(5 * t)[:, None, None, None]
    valid = torch.arange(k, device="cuda") >= k - live
    clip_t = torch.tensor(clip, device="cuda")
    target = torch.full((), 0.25, device="cuda")
    got = predict_hermite(hist, t, target, order=3, valid=valid, clip_target=clip_t)
    want = predict_hermite(hist.cpu(), t.cpu(), target.cpu(), order=3, valid=valid.cpu(),
                           clip_target=clip_t.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


def test_freqca_skip_and_fresca_read_nothing_back_from_the_card(cuda):
    """A FreqCa skip step's prediction and a FreSca call queue work on the
    card without one host synchronization (the skip decision, made before,
    is the step's one read)."""
    from fdtpu_torch.cache import E2CRFConfig, init_cache_state
    from fdtpu_torch.ops.fresca import apply_fresca_to_score
    from fdtpu_torch.sampling import sampler as psampler

    b, t_len, k = 128, 187, 10
    cfg = E2CRFConfig(level="score", eps_predictor="freqca", max_history=k, hermite_order=3)
    state = init_cache_state(cfg, b, t_len, 1, "cuda").replace(
        cold=False, step=40, last_full_step=37,
        hist_len=torch.full((), 6, dtype=torch.int32, device="cuda"),
        crf_t_hist=torch.linspace(0.99, 0.9, k, device="cuda"),
        crf_high_hist=torch.randn((k, b, t_len, 1), generator=cuda, device="cuda"),
        crf_low=torch.randn((b, t_len, 1), generator=cuda, device="cuda"),
        eps_hat=torch.randn((b, t_len, 1), generator=cuda, device="cuda"))
    t = torch.full((), 0.88, device="cuda")
    std = torch.rand((b, t_len), generator=cuda, device="cuda") + 0.5
    score = torch.randn((b, t_len, 1), generator=cuda, device="cuda")
    # Warm up: cuFFT plans, cuSOLVER handles and the allocator's first blocks.
    psampler._skip(state, cfg, t, std, t_len)
    apply_fresca_to_score(score, 1.0, 1.5, 0.5, "energy", timestep=t, num_steps=1000)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        skipped, new = psampler._skip(state, cfg, t, std, t_len)
        scaled = apply_fresca_to_score(score, 1.0, 1.5, 0.5, "energy", timestep=t,
                                       num_steps=1000)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert new.cached_steps == state.cached_steps + 1
    assert bool(torch.isfinite(skipped).all()) and bool(torch.isfinite(scaled).all())
