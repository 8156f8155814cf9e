"""Card-only tests of the port's CUDA kernels (forward B1, backward B2,
token-major attention B4) and of the autograd Function over B1 and B2 (B3),
held against their plain PyTorch versions on the card, and of a token-level
and a KV-level chain through them; the kernels' registered operators under
``torch.library.opcheck``, and the exported sampling program at the
flagship's width against the sampler.  They skip without a CUDA device.

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

import json

import pytest
import torch

from fdtpu_torch.kernels import attention as mha
from fdtpu_torch.kernels import blockdiag_attention as bda
from fdtpu_torch.sampling import DiffusionSampler

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
    from fdtpu_torch.cache import E2CRFConfig, e2crf, init_cache_state
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
    psampler._skip(state, cfg, t, std)
    apply_fresca_to_score(score, 1.0, 1.5, 0.5, "energy", timestep=t, num_steps=1000)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        skipped, new = psampler._skip(state, cfg, t, std)
        scaled = apply_fresca_to_score(score, 1.0, 1.5, 0.5, "energy", timestep=t,
                                       num_steps=1000)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert e2crf.count_mode(new, "score", 0, t_len).cached_steps == state.cached_steps + 1
    assert bool(torch.isfinite(skipped).all()) and bool(torch.isfinite(scaled).all())


# ------------------------------------------------------------- CUDA graphs
GRAPH_CHAINS = {
    "uncached": (None, {}),
    "score": (dict(level="score", R=8, tau_0=0.5, guard="off"), {}),
    "score-freqca-fresca": (dict(level="score", R=8, tau_0=0.5, eps_predictor="freqca",
                                 max_history=4, hermite_order=2, guard="off"),
                            dict(use_fresca=True)),
    "token": (dict(level="token", token_budget=4, tau_0=5.0, R=12, random_probe_ratio=0.2,
                   guard="off"), {}),
    "kv-event-freqca": (dict(level="kv", policy="event", K=1, R=6, tau_0=0.5, tau_warn=1e9,
                             random_probe_ratio=0.1, use_freqca=True, freq_decomp_interval=4),
                        {}),
    "kv-macro": (dict(level="kv", policy="macro", K=2, R=100), {}),
}


def _graph_model(attention_impl="blockdiag", dropout=0.0, backbone="transformer", device=None,
                 channels=2):
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model

    cfg = ScoreModelConfig(n_channels=channels, max_len=33, d_model=24, num_layers=2, n_head=4,
                           dim_feedforward=48, attention_impl=attention_impl, dropout=dropout,
                           backbone=backbone, d_mlp=40)
    net = init_score_model(cfg, torch.Generator().manual_seed(0), device)
    sched = VPScheduler(fourier_noise_scaling=True, beta_max=2.0).with_noise_scaling(
        33, device or "cuda")
    return ScoreModel(config=cfg, network=net, scheduler=sched)


def _draws(num_batches, n, t_len=33, channels=2, batch=4, seed=7):
    """Prior, step and probe draws for ``num_batches`` batches of ``n`` steps."""
    g = torch.Generator().manual_seed(seed)
    return dict(prior_noise=torch.randn((num_batches * batch, t_len, channels), generator=g),
                step_noise=torch.randn((n, num_batches * batch, t_len, channels), generator=g),
                probe_noise=torch.rand((num_batches, n, t_len), generator=g))


def _resident_against_eager(model, kw, options, n, batch, injected):
    """Three batches at ``batches_per_call`` 1 (the eager loop) and 2 (two
    trajectories as replays of the resident graph and the remainder a third
    replay), twice over the same samplers."""
    layers = model.config.num_layers
    level = kw["level"] if kw else None
    samplers = {k: DiffusionSampler(model, batch, use_cache=kw is not None, cache_kwargs=kw,
                                    batches_per_call=k, **options) for k in (1, 2)}
    t_len, channels = model.config.max_len, model.config.n_channels
    for _ in range(2):
        runs = {}
        for k, sampler in samplers.items():
            bda.launches = mha.launches = 0
            draws = (_draws(3, n, t_len, channels, batch) if injected
                     else dict(generator=torch.Generator("cuda").manual_seed(5)))
            x = sampler.sample(3 * batch, n, **draws)
            torch.cuda.synchronize()
            runs[k] = (x, sampler.last_modes, sampler.get_cache_stats(),
                       (bda.launches, mha.launches))
        (x1, m1, s1, c1), (x2, m2, s2, c2) = runs[1], runs[2]
        if kw is not None:
            first = (m1 != m2).nonzero()
            assert m1.shape == m2.shape == (3, n) and not len(first), \
                f"modes differ first at (batch, step) {first[:1].tolist()}"
        assert s1 == s2 and c1 == c2
        full = s1["full_steps"] if kw else 3 * n
        cached = (s1.get("mixed_steps", 0) + s1.get("cached_steps", 0) if level == "kv"
                  else s1.get("mixed_steps", 0) if level == "token" else 0)
        assert c2 == (layers * full, layers * cached)
        assert torch.equal(x2, x1), f"samples differ by {float((x2 - x1).abs().max()):.3g}"
    (chain,) = samplers[2]._chains.values()
    assert chain.loop is not None
    assert any(seg.launched[0] for seg in chain.loop.branches)
    if level in ("token", "kv"):
        assert any(seg.launched[3] for seg in chain.loop.branches)
    return samplers[2]


@pytest.mark.parametrize("injected", [True, False], ids=["injected", "generator"])
@pytest.mark.parametrize("name", list(GRAPH_CHAINS))
def test_graphed_chain_equals_the_eager_chain(cuda, name, injected):
    """The resident chain (``batches_per_call=2``: a trajectory a replay,
    its decisions in conditional nodes) against the eager loop at 50 steps,
    with injected noise and with a generator: the same mode at every step,
    equal cache statistics and launch counts (B1 per layer and full forward,
    B4 per layer and cached step, through replays), samples bitwise."""
    kw, options = GRAPH_CHAINS[name]
    _resident_against_eager(_graph_model(), kw, options, 50, 4, injected)


FLAGSHIP_CHAINS = {
    "uncached": (None, {}),
    "score": ({"level": "score", "R": 100, "tau_0": 1.35, "eps_order": 1}, {}),
    "token": ({"level": "token", "token_budget": 24, "tau_0": 0.5, "R": 100}, {}),
    "kv-event": ({"level": "kv", "policy": "event", "K": 0, "R": 100, "tau_0": 10.0,
                  "tau_warn": 1e9}, {}),
    "kv-macro": ({"level": "kv", "policy": "macro", "K": 5, "R": 10}, {}),
    "score-freqca": ({"level": "score", "R": 100, "tau_0": 1.35, "eps_predictor": "freqca"},
                     {}),
    "score-fresca": ({"level": "score", "R": 100, "tau_0": 1.35}, {"use_fresca": True}),
    "kv-event-freqca": ({"level": "kv", "policy": "event", "K": 0, "R": 100, "tau_0": 10.0,
                         "tau_warn": 1e9, "use_freqca": True}, {}),
}


@pytest.mark.parametrize("injected", [True, False], ids=["injected", "generator"])
@pytest.mark.parametrize("name", list(FLAGSHIP_CHAINS))
def test_resident_trajectory_at_the_flagship_equals_the_eager_loop(cuda, name, injected):
    """The flagship (d_model 72, 10 layers, 12 heads, 187 tokens; random
    weights) at every level and option, 3 batches of 8 at 40 steps: as
    above, modes, statistics, B1/B4 counts equal and samples bitwise."""
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model

    cfg = ScoreModelConfig(n_channels=1, max_len=187, attention_impl="blockdiag")
    net = init_score_model(cfg, torch.Generator().manual_seed(0), "cuda")
    model = ScoreModel(config=cfg, network=net, scheduler=VPScheduler(
        fourier_noise_scaling=True).with_noise_scaling(187, "cuda"))
    kw, options = FLAGSHIP_CHAINS[name]
    _resident_against_eager(model, kw, options, 40, 8, injected)


def test_no_two_steps_see_the_same_noise(cuda):
    """The prologue draws each step's noise and probe uniforms apart: no two
    steps of a trajectory, nor two trajectories, share them."""
    kw, options = GRAPH_CHAINS["token"]
    sampler = DiffusionSampler(_graph_model(), 4, use_cache=True, cache_kwargs=kw,
                               batches_per_call=2, **options)
    sampler.sample(8, 30, generator=torch.Generator("cuda").manual_seed(1))
    (chain,) = sampler._chains.values()
    first = (chain.noise.clone(), chain.probes.clone())
    chain.begin_call(torch.Generator("cuda").manual_seed(2))
    chain.run_resident()
    for buf, before in zip((chain.noise, chain.probes), first):
        rows = buf.reshape(buf.shape[0], -1)
        assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
        assert not bool((buf == before).all(dim=tuple(range(1, buf.ndim))).any())


def test_graphed_train_steps_equal_eager_steps_with_dropout(cuda):
    """Eight optimizer steps with dropout on, as replays of the captured
    step graph (two calls of four) and eagerly: the same losses and
    parameters (rtol 2e-5 / atol 2e-6, tests/test_trainer_chunked.py's),
    B2 and B3 counted through replays."""
    import numpy as np

    from fdtpu_torch.train import make_optimizer, train_step
    from fdtpu_torch.train.trainer import GraphedSteps

    model = _graph_model(dropout=0.1)
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((8, 33, 2)).astype(np.float32) for _ in range(8)]
    results = []
    for graphed in (False, True):
        net = _graph_model(dropout=0.1).network.train().requires_grad_(True)
        opt = make_optimizer(net.parameters(), 1e-3, 20)
        gen = torch.Generator("cuda").manual_seed(9)
        bda.launches_bwd = bda.launches_trainable = 0
        if graphed:
            steps = GraphedSteps(net, opt, model.scheduler, gen, False, 4)
            losses = torch.cat([steps.run(batches[:4]), steps.run(batches[4:])])
            assert steps.runner.replays == 7
        else:
            losses = torch.stack([train_step(net, opt, model.scheduler,
                                             torch.from_numpy(b).cuda(), gen) for b in batches])
        torch.cuda.synchronize()
        assert (bda.launches_bwd, bda.launches_trainable) == (2 * 8, 2 * 8)
        assert opt.count == 8
        results.append((losses, [p.detach().clone() for p in net.parameters()]))
    (l1, p1), (l2, p2) = results
    torch.testing.assert_close(l2, l1, rtol=2e-4, atol=0)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(b, a, rtol=2e-5, atol=2e-6)


def test_graphed_accumulation_steps_equal_eager_steps(cuda):
    """``accumulate_grad_batches=2``: two step graphs a batch shape (the
    micro-step that only accumulates, the one that also updates), replayed,
    against the eager micro-steps: the same losses and parameters (bitwise
    expected; rtol 2e-5 / atol 2e-6 as above), four updates in eight."""
    import numpy as np

    from fdtpu_torch.train import make_optimizer, train_step
    from fdtpu_torch.train.trainer import GraphedSteps

    model = _graph_model(dropout=0.1)
    rng = np.random.default_rng(1)
    batches = [rng.standard_normal((8, 33, 2)).astype(np.float32) for _ in range(8)]
    results = []
    for graphed in (False, True):
        net = _graph_model(dropout=0.1).network.train().requires_grad_(True)
        opt = make_optimizer(net.parameters(), 1e-3, 20, accumulate_grad_batches=2)
        gen = torch.Generator("cuda").manual_seed(9)
        if graphed:
            steps = GraphedSteps(net, opt, model.scheduler, gen, False, 8)
            losses = torch.cat([steps.run(batches[:3]), steps.run(batches[3:])])
            assert sorted(k[1] for k in steps.runner.graphs) == [False, True]
        else:
            losses = torch.stack([train_step(net, opt, model.scheduler,
                                             torch.from_numpy(b).cuda(), gen) for b in batches])
        torch.cuda.synchronize()
        assert (opt.count, int(opt.updates), opt.mini_step) == (4, 4, 0)
        results.append((losses, [p.detach().clone() for p in net.parameters()]))
    (l1, p1), (l2, p2) = results
    torch.testing.assert_close(l2, l1, rtol=2e-4, atol=0)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(b, a, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("backbone", ["mlp", "lstm"])
def test_mlp_and_lstm_on_the_card(cuda, backbone):
    """The MLP and LSTM backbones: the forward on the card against the CPU
    (atol 2e-5, the einsum transformer's tolerance against JAX), and the
    grouped sampler's replays of captured graphs against the eager chain
    (rtol 2e-5 / atol 5e-5, as the transformer's chains above)."""
    model = _graph_model(backbone=backbone)
    cpu = _graph_model(backbone=backbone, device="cpu")
    x = torch.randn((4, 33, 2), generator=cuda, device="cuda")
    t = torch.rand((4,), generator=cuda, device="cuda")
    torch.testing.assert_close(model.network(x, t).cpu(), cpu.network(x.cpu(), t.cpu()),
                               rtol=0, atol=2e-5)
    samples = {}
    for k in (1, 2):
        sampler = DiffusionSampler(model, 4, batches_per_call=k)
        samples[k] = sampler.sample(12, 20, generator=torch.Generator("cuda").manual_seed(5))
    (chain,) = sampler._chains.values()
    assert chain.loop is not None
    torch.testing.assert_close(samples[2], samples[1], rtol=2e-5, atol=5e-5)


def test_graph_replays_read_nothing_back_from_the_card(cuda, monkeypatch):
    """Every replay of a sampler's resident graphs and of a trainer's step
    graphs runs under ``set_sync_debug_mode("error")``: no graph reads the
    host."""
    import numpy as np

    from fdtpu_torch.train import make_optimizer
    from fdtpu_torch.train.trainer import GraphedSteps
    from fdtpu_torch.utils import conditional, graphs

    replays = []

    def strict(real):
        def replay(self):
            torch.cuda.set_sync_debug_mode("error")
            try:
                real(self)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            replays.append(1)
        return replay

    monkeypatch.setattr(graphs.CudaGraph, "replay", strict(graphs.CudaGraph.replay))
    monkeypatch.setattr(conditional.LoopGraph, "replay", strict(conditional.LoopGraph.replay))
    model = _graph_model()
    for name in ("score-freqca-fresca", "token", "kv-event-freqca"):
        kw, options = GRAPH_CHAINS[name]
        sampler = DiffusionSampler(model, 4, use_cache=True, cache_kwargs=kw,
                                   batches_per_call=2, **options)
        sampler.sample(8, 30, generator=torch.Generator("cuda").manual_seed(1))
    net = _graph_model(dropout=0.1).network.train().requires_grad_(True)
    steps = GraphedSteps(net, make_optimizer(net.parameters(), 1e-3, 20), model.scheduler,
                         torch.Generator("cuda").manual_seed(2), False, 4)
    steps.run([np.ones((8, 33, 2), np.float32)] * 4)
    torch.cuda.synchronize()
    # Two trajectories a sampler, each one replay; three step replays.
    assert len(replays) == 3 * 2 + 3


def test_a_failed_capture_raises_instead_of_running_eager(cuda, monkeypatch):
    """A trajectory graph whose conditional nodes the runtime refuses, or
    whose capture fails, raises: no eager retry."""
    from fdtpu_torch.utils import conditional

    real = conditional._library()

    class Refusing:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def fdtpu_cond_begin_while(*args):
            return 1  # cudaErrorInvalidValue

    def sampler():
        return DiffusionSampler(_graph_model(), 4, use_cache=True,
                                cache_kwargs=GRAPH_CHAINS["score"][0], batches_per_call=2)

    with monkeypatch.context() as mp:
        mp.setattr(conditional, "_library", lambda: Refusing())
        with pytest.raises(RuntimeError, match="the WHILE node failed"):
            sampler().sample(8, 10, generator=torch.Generator("cuda").manual_seed(1))

    def refuse(self, *args):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(conditional.LoopGraph, "_append_loop", refuse)
    with pytest.raises(RuntimeError, match="capture refused"):
        sampler().sample(8, 10, generator=torch.Generator("cuda").manual_seed(1))


# ------------------------------------------------ the resident epoch loop
def _resident_fit(tmp_path, run_id, epochs, per_call, horizon=None, **kw):
    from fdtpu_torch.data import SyntheticDatamodule
    from fdtpu_torch.train import Trainer, get_training_params

    dm = SyntheticDatamodule(tmp_path / "data", max_len=33, num_samples=90, batch_size=16,
                             fourier_transform=True, standardize=True, random_seed=2)
    dm.prepare_data()
    dm.setup()
    model = _graph_model(dropout=0.1, channels=1)
    model.num_training_steps = get_training_params(dm, horizon or epochs)["num_training_steps"]
    trainer = Trainer(max_epochs=epochs, run_dir=tmp_path / "runs", run_id=run_id, seed=3,
                      log_every_n_steps=1, epochs_per_call=per_call, **kw)
    bda.launches = bda.launches_bwd = 0
    model = trainer.fit(model, dm)
    torch.cuda.synchronize()
    records = [json.loads(r) for r in trainer.metrics_path.read_text().splitlines()]
    for r in records:
        r.pop("epoch_time_s", None)
    batches = (len(dm.train_dataloader()), len(dm.val_dataloader()))
    return model, trainer, records, (bda.launches, bda.launches_bwd, *batches)


def test_resident_epochs_are_one_graph_a_call_and_do_not_depend_on_epochs_per_call(
        cuda, tmp_path):
    """Four epochs (90 train rows in batches of 16: a partial batch; dropout
    on) at ``epochs_per_call`` 2 and 3: captured graphs (one for two epochs;
    one for three and one for the one-epoch tail), B1 and B2 counted
    through their replays, and the same per-step and per-epoch losses,
    rates, best val loss and parameters, bitwise."""
    from fdtpu_torch.train import trainer as trainer_mod

    made = []
    real_init = trainer_mod.ResidentEpochs.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)

    trainer_mod.ResidentEpochs.__init__ = init
    try:
        runs = {k: _resident_fit(tmp_path, f"k{k}", 4, k) for k in (2, 3)}
    finally:
        trainer_mod.ResidentEpochs.__init__ = real_init
    (m2, t2, r2, c2), (m3, t3, r3, c3) = runs[2], runs[3]
    assert sorted(made[0].graphs) == [(2, 0)] and sorted(made[1].graphs) == [(1, 0), (3, 0)]
    assert r2 == r3 and sum("val/loss" in r for r in r2) == 4
    assert t2.best_val_loss == t3.best_val_loss
    steps, vals = 4 * c2[2], 4 * c2[3]
    assert c2 == c3 == (2 * (steps + vals), 2 * steps, 6, 6)  # 2 layers
    for a, b in zip(m2.network.state_dict().values(), m3.network.state_dict().values()):
        assert torch.equal(a, b)


def test_resident_epochs_resume_on_the_card(cuda, tmp_path):
    """Two epochs and ``resume=True`` up to four against four straight, at
    ``epochs_per_call=2``: the resumed epochs' records, the best val loss and
    the parameters bitwise."""
    m_full, t_full, r_full, _ = _resident_fit(tmp_path, "full", 4, 2)
    _resident_fit(tmp_path, "part", 2, 2, horizon=4)
    m_part, t_part, r_part, _ = _resident_fit(tmp_path, "part", 4, 2, horizon=4, resume=True)
    assert r_part == r_full
    assert t_part.best_val_loss == t_full.best_val_loss
    for a, b in zip(m_full.network.state_dict().values(), m_part.network.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["score", "token"])
def test_profiled_back_to_back_resident_calls(cuda, name):
    """The flagship's resident chain (``batches_per_call=2``, 256 samples in
    batches of 128, 50 steps: a call is two trajectories) profiled by
    torch.profiler (CUPTI) over two calls back to back, in three windows:
    the window in which an illegal memory access once stopped a run.  Every
    profiled call's samples equal the unprofiled call's bitwise."""
    from torch.profiler import ProfilerActivity, profile

    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model

    cfg = ScoreModelConfig(n_channels=1, max_len=187, attention_impl="blockdiag")
    net = init_score_model(cfg, torch.Generator().manual_seed(0), "cuda")
    model = ScoreModel(config=cfg, network=net, scheduler=VPScheduler(
        fourier_noise_scaling=True).with_noise_scaling(187, "cuda"))
    sampler = DiffusionSampler(model, 128, use_cache=True, cache_kwargs=FLAGSHIP_CHAINS[name][0],
                               batches_per_call=2)

    def call():
        return sampler.sample(256, 50, generator=torch.Generator("cuda").manual_seed(3))

    want = call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = [call(), call()]
            torch.cuda.synchronize()
        assert any(e.key == "cudaGraphLaunch" for e in prof.key_averages())
        for x in got:
            assert torch.equal(x, want)


@pytest.mark.parametrize("name", ["uncached", "score"])
def test_recorded_chain_counts_the_same_nodes_at_every_capture(cuda, name):
    """Two samplers capture the same chain: their prologue, WHILE body and
    branches hold the same kernel nodes, every segment launches kernels, and
    a recorded call counts the same kernels a step."""
    from fdtpu_torch.utils import profiling

    kw = GRAPH_CHAINS[name][0] if name != "uncached" else None
    per_step, loops = [], []
    for _ in range(2):
        sampler = DiffusionSampler(_graph_model(), 4, use_cache=kw is not None, cache_kwargs=kw,
                                   batches_per_call=2)
        draws = _draws(2, 30)
        sampler.sample(8, 30, **draws)  # captures
        with profiling.recording():
            sampler.sample(8, 30, **draws)
        counters = profiling.export()["counters"]
        assert counters["chain.steps"] == 60
        runs = sum(v for k, v in counters.items() if k.startswith("chain.runs."))
        assert runs == 60
        per_step.append(counters["chain.kernels"] / 60)
        (chain,) = sampler._chains.values()
        loop = chain.loop
        segments = [seg for seg in [loop.pre, loop.post, *loop.branches] if seg]
        assert loop.counted
        loops.append((loop.prologue_launched, [seg.launched for seg in segments]))
        assert all(seg.launched[-1] > 0 for seg in segments)
        assert loop.prologue_launched[-1] > 0
    assert per_step[0] == per_step[1] and per_step[0] > 0
    assert loops[0] == loops[1]


@pytest.mark.parametrize("name", ["uncached", "score"])
def test_recorded_replays_time_the_device_with_no_added_synchronize(cuda, monkeypatch, name):
    """Inside a recording, two resident calls make no synchronise and no
    event wait of the recorder's; each replay's device interval is read
    (at the chain's read, or at the recording's end) and is positive."""
    from fdtpu_torch.utils import profiling

    kw = GRAPH_CHAINS[name][0] if name != "uncached" else None
    sampler = DiffusionSampler(_graph_model(), 4, use_cache=kw is not None, cache_kwargs=kw,
                               batches_per_call=2)
    draws = _draws(2, 30)
    sampler.sample(8, 30, **draws)  # captures
    torch.cuda.synchronize()
    waits = []
    with profiling.recording() as rec:
        with monkeypatch.context() as mp:
            for owner, attr in ((torch.cuda, "synchronize"), (torch.cuda.Event, "synchronize")):
                real = getattr(owner, attr)
                mp.setattr(owner, attr, lambda *a, real=real, attr=attr, **k:
                           waits.append(attr) or real(*a, **k))
            for _ in range(2):
                sampler.sample(8, 30, **draws)
            assert waits == []
            if kw is not None:  # read at the chain's read
                assert rec.pending == []
    replays = [s for s in profiling.export()["spans"] if s["name"] == "fdtpu.sample.replay"]
    assert len(replays) == 4
    for s in replays:
        assert s["device_end_ns"] > s["device_start_ns"] >= rec.base_ns


def test_profiled_training_epoch_opens_the_spans_as_profiler_ranges(cuda, tmp_path):
    """A fit profiled with CPU and CUDA activity, no recording open: the
    trainer's spans are profiler ranges (the benchmark's reading of them is
    ``portbench/tests/test_span_trace.py``'s)."""
    from fdtpu_torch.data import SyntheticDatamodule
    from fdtpu_torch.train import Trainer, get_training_params

    dm = SyntheticDatamodule(tmp_path / "data", max_len=33, num_samples=90, batch_size=16,
                             fourier_transform=True, standardize=True, random_seed=2)
    dm.prepare_data()
    dm.setup()
    model = _graph_model(dropout=0.1, channels=1)
    model.num_training_steps = get_training_params(dm, 2)["num_training_steps"]
    trainer = Trainer(max_epochs=2, run_dir=tmp_path / "runs", run_id="p", seed=3)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        trainer.fit(model, dm)
    names = {e.name for e in prof.events()}
    assert {"fdtpu.fit", "fdtpu.fit.epoch", "fdtpu.fit.steps", "fdtpu.fit.epoch_end",
            "fdtpu.fit.validation", "fdtpu.fit.resume_state"} <= names


# ------------------------------------------------------------- export
@pytest.mark.parametrize("op", ["blockdiag_mha", "blockdiag_mha_bwd", "fused_mha"])
def test_registered_operators_pass_opcheck_on_the_card(cuda, op):
    """Each ``fdtpu::`` operator on CUDA tensors at the flagship's head
    layout (B4 at the token level's TOPK shape, 24 rows against 187 keys):
    its CUDA implementation launches the kernel and agrees with the fake
    one."""
    q, k, v = _inputs(cuda, 8, 187, 12, 6)
    args = {
        "blockdiag_mha": (q, k, v, True),
        "blockdiag_mha_bwd": (q, k, v, torch.randn(q.shape, generator=cuda, device="cuda")),
        "fused_mha": (q.reshape(8, 187, 12, 6)[:, :24].contiguous(),
                      k.permute(0, 3, 1, 2).contiguous(), v.permute(0, 2, 1, 3).contiguous()),
    }[op]
    counter = {"blockdiag_mha": (bda, "launches"), "blockdiag_mha_bwd": (bda, "launches_bwd"),
               "fused_mha": (mha, "launches")}[op]
    before = getattr(*counter)
    torch.library.opcheck(getattr(torch.ops.fdtpu, op).default, args)
    torch.cuda.synchronize()
    assert getattr(*counter) > before


@pytest.mark.parametrize("name", ["uncached", "score", "token", "score-freqca",
                                  "kv-event-freqca"])
def test_exported_flagship_program_equals_the_sampler(cuda, tmp_path, name):
    """The flagship's program (d_model 72, 10 layers, 12 heads, 187 tokens;
    a batch of 128, 50 steps) exported, reloaded and run from a generator:
    bitwise the eager loop's first batch and the resident chain's from the
    same generator, with B1 launched 10 times a full forward and B4 10 times
    a TOPK step (a MIXED or CACHED step at the KV level) of the sampler's
    chain.  FreqCa's programs solve through ``fdtpu::hermite_solve``, whose
    CUDA implementation pins cuSOLVER inside the operator."""
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
    from fdtpu_torch.serve import export_sampler, load_exported

    cfg = ScoreModelConfig(n_channels=1, max_len=187, attention_impl="blockdiag")
    net = init_score_model(cfg, torch.Generator().manual_seed(0), "cuda")
    model = ScoreModel(config=cfg, network=net, scheduler=VPScheduler(
        fourier_noise_scaling=True).with_noise_scaling(187, "cuda"))
    kw, options = FLAGSHIP_CHAINS[name]

    def sampler(per_call):
        return DiffusionSampler(model, 128, use_cache=kw is not None, cache_kwargs=kw,
                                batches_per_call=per_call, **options)

    eager = sampler(1)
    meta = export_sampler(eager, 50, tmp_path / "p.pt2")
    assert meta["platforms"] == ["cuda"]
    fn = load_exported(tmp_path / "p.pt2")
    bda.launches = mha.launches = 0
    got = fn(torch.Generator("cuda").manual_seed(3))
    torch.cuda.synchronize()
    launched = (bda.launches, mha.launches)
    want = eager.sample(128, 50, generator=torch.Generator("cuda").manual_seed(3))
    stats = eager.get_cache_stats()
    resident = sampler(2).sample(256, 50, generator=torch.Generator("cuda").manual_seed(3))
    assert torch.equal(got, want), f"max diff {float((got - want).abs().max()):.3g}"
    assert torch.equal(got, resident[:128])
    full = stats["full_steps"] if kw else 50
    cached = (stats["mixed_steps"] + stats["cached_steps"] if name.startswith("kv")
              else stats["mixed_steps"] if name == "token" else 0)
    assert launched == (10 * full, 10 * cached)


# ------------------------------------------------------------- the mesh
@pytest.fixture
def one_rank_world(cuda, tmp_path):
    """A one-process NCCL world (the card is one) and its ``("data",
    "model")`` mesh; destroyed after the test."""
    import torch.distributed as dist

    from fdtpu_torch.dist import create_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield create_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("per_call", [1, 2], ids=["eager", "resident"])
@pytest.mark.parametrize("name", ["uncached", "score", "kv-event", "token", "score-freqca",
                                  "score-fresca"])
def test_mesh_sampler_at_world_size_one_equals_the_sampler(one_rank_world, name, per_call):
    """``DiffusionSampler(mesh=)`` on a one-rank NCCL mesh, at the flagship
    (2 batches of 64, 50 steps), eager and resident (the collectives inside
    the trajectory's graph): samples, modes and statistics bitwise the
    sampler's without a mesh from the same generator, B1 and B4 launched as
    often."""
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model

    cfg = ScoreModelConfig(n_channels=1, max_len=187, attention_impl="blockdiag")
    net = init_score_model(cfg, torch.Generator().manual_seed(0), "cuda")
    model = ScoreModel(config=cfg, network=net, scheduler=VPScheduler(
        fourier_noise_scaling=True).with_noise_scaling(187, "cuda"))
    kw, options = FLAGSHIP_CHAINS[name]
    runs = []
    for mesh in (None, one_rank_world):
        sampler = DiffusionSampler(model, 64, use_cache=kw is not None, cache_kwargs=kw,
                                   batches_per_call=per_call, mesh=mesh, **options)
        bda.launches = mha.launches = 0
        x = sampler.sample(128, 50, generator=torch.Generator("cuda").manual_seed(3))
        torch.cuda.synchronize()
        runs.append((x, sampler.last_modes, sampler.get_cache_stats(),
                     (bda.launches, mha.launches)))
    (x0, m0, s0, c0), (x1, m1, s1, c1) = runs
    assert torch.equal(x1, x0), f"max diff {float((x1 - x0).abs().max()):.3g}"
    assert (m0 is None and m1 is None) or torch.equal(m1, m0)
    assert s1 == s0 and c1 == c0 and c1[0] > 0


@pytest.mark.parametrize("loop", [dict(steps_per_call=16), dict(epochs_per_call=2),
                                  dict(steps_per_call=1, accumulate_grad_batches=2)],
                         ids=["graphed", "resident", "accumulate"])
def test_mesh_trainer_at_world_size_one_equals_the_trainer(one_rank_world, tmp_path, loop):
    """``Trainer(mesh=)`` on a one-rank NCCL mesh (the gradients' all-reduce
    captured in the step graphs and the epoch graph): parameters and best val
    loss bitwise the trainer's without a mesh; a small transformer, 2
    epochs."""
    from fdtpu_torch.data import SyntheticDatamodule
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
    from fdtpu_torch.train import Trainer, get_training_params

    dm = SyntheticDatamodule(tmp_path / "data", max_len=32, num_samples=300, batch_size=32,
                             fourier_transform=True, standardize=True)
    dm.prepare_data()
    dm.setup()
    cfg = ScoreModelConfig(n_channels=1, max_len=32, d_model=24, num_layers=2, n_head=4,
                           dim_feedforward=64, attention_impl="blockdiag")
    sched = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(32, "cuda")
    steps = get_training_params(dm, 2, loop.get("accumulate_grad_batches", 1))
    fits = []
    for mesh in (None, one_rank_world):
        model = ScoreModel(cfg, init_score_model(cfg, torch.Generator().manual_seed(0), "cuda"),
                           sched, num_training_steps=steps["num_training_steps"])
        trainer = Trainer(max_epochs=2, run_dir=tmp_path / "runs", run_id=str(mesh is None),
                          seed=3, mesh=mesh, save_resume_state=False, **loop)
        fits.append((trainer.fit(model, dm).network.state_dict(), trainer.best_val_loss))
    (p0, v0), (p1, v1) = fits
    assert v1 == v0 and all(torch.equal(p1[k], p0[k]) for k in p0)


# ------------------------------------------------ the score chain's step kernels
def _step_chain(kind="vp", **cache):
    """A resident score-level chain of the small graph model on the card (4
    rows of 33 × 2, 20 steps, R 10, τ₀ 0.3), its step kernels engaged."""
    from fdtpu_torch.cache.e2crf import E2CRFConfig, init_cache_state
    from fdtpu_torch.diffusion import VEScheduler
    from fdtpu_torch.sampling import resident
    from fdtpu_torch.sampling.sampler import no_fresca

    model = _graph_model()
    sched = (model.scheduler if kind == "vp" else VEScheduler(
        fourier_noise_scaling=True, sigma_max=2.0).with_noise_scaling(33, "cuda"))
    cfg = E2CRFConfig(level="score", R=10, tau_0=0.3, **cache)
    chain = resident.Chain(model.network, sched, cfg, cfg.policy_params("cuda"),
                           init_cache_state(cfg, 4, 33, 2, "cuda"), 4, 20, no_fresca, "cuda",
                           resident=True)
    assert chain.step_kernels
    return chain


@pytest.mark.parametrize("auto_calibrate", [False, True])
@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("kind", ["vp", "ve"])
def test_chain_step_kernels_equal_the_chains_segments(cuda, kind, order, auto_calibrate):
    """Each of the three kernels from the same states as the chain's PyTorch
    segment it replaces (the kernels' plain versions, run on the card with
    the kernels off), over the boundary and random states of
    ``tests/chain_step_states.py``, ``post`` after a skip and after a
    refresh: every static tensor bitwise, one launch counted, a synchronise
    after each launch."""
    import numpy as np
    from chain_step_states import load, states

    from fdtpu_torch.kernels import chain_step

    chain = _step_chain(kind, eps_order=order, auto_calibrate=auto_calibrate)
    c, pp = chain.tensors, chain.pp
    pre = (chain.clock, chain.mode, chain.sem, chain.modes, c["drift_rate"], c["err_acc"],
           pp.tau_0, c["overrun"], pp.R, auto_calibrate)
    skip = (chain.clock, chain.ts, chain.G, c["eps_hat"], c["eps_prev"], c["eps_prev2"],
            c["eps_gap"], c["eps_gap2"], c["drift_rate"], c["err_acc"], chain.score, order,
            chain.scheduler)
    post = (chain.clock, chain.sem, chain.ts, chain.step_size, chain.G, chain.score, chain.noise,
            chain.x, chain.done, chain.scheduler, 33)

    def torch_post():
        chain.step_kernels = False
        try:
            chain._post()
        finally:
            chain.step_kernels = True

    segments = {"pre": (chain_step.score_pre, chain._score_pre, pre, (0,)),
                "skip": (chain_step.score_skip, chain._skip, skip, (0,)),
                "post": (chain_step.score_post, torch_post, post, (0, 1))}
    statics = dict(x=chain.x, score=chain.score, clock=chain.clock, mode=chain.mode,
                   sem=chain.sem, modes=chain.modes, done=chain.done, **c)
    for seed, fields in enumerate(states(10, float(np.float32(0.3)))):
        for name, (kernel, segment, args, sems) in segments.items():
            for sem in sems:
                results = []
                for run in (segment, lambda: kernel(*args)):
                    load(chain, fields, seed)
                    chain.sem.fill_(sem)
                    before = getattr(chain_step, f"launches_{name}")
                    run()
                    torch.cuda.synchronize()
                    launched = getattr(chain_step, f"launches_{name}") - before
                    results.append({k: v.clone() for k, v in statics.items()})
                assert launched == 1
                want, got = results
                for k in want:
                    assert torch.equal(got[k], want[k]), (name, seed, sem, k)


def test_resident_score_chain_with_step_kernels_matches_the_cpu(cuda):
    """A resident score chain (its steps the kernels on the card, PyTorch's
    segments on the CPU), VE (see the cached-chain test above), ε̂ order 2,
    injected draws: the same mode at every step, the same counters, the
    samples at atol 1e-4."""
    from fdtpu_torch.diffusion import VEScheduler
    from fdtpu_torch.models import ScoreModel

    kw = dict(level="score", R=6, tau_0=0.4, eps_order=2, guard="off")
    draws = _draws(2, 40)
    out = {}
    for dev in ("cuda", "cpu"):
        base = _graph_model(device=dev)
        model = ScoreModel(config=base.config, network=base.network, scheduler=VEScheduler(
            fourier_noise_scaling=True, sigma_max=2.0).with_noise_scaling(33, dev))
        sampler = DiffusionSampler(model, 4, use_cache=True, cache_kwargs=kw, batches_per_call=2)
        x = sampler.sample(8, 40, **draws)
        torch.cuda.synchronize()
        (chain,) = sampler._chains.values()
        assert chain.step_kernels == (dev == "cuda")
        out[dev] = (x.cpu(), sampler.last_modes.cpu(), sampler.get_cache_stats())
    (xc, mc, sc), (xh, mh, sh) = out["cuda"], out["cpu"]
    first = (mc != mh).nonzero()
    assert not len(first), f"modes differ first at (batch, step) {first[:1].tolist()}"
    for key in ("current_step", "full_steps", "cached_steps", "recompute_count",
                "cache_hit_count"):
        assert sc[key] == sh[key], key
    assert 0 < sc["cached_steps"] < 80
    torch.testing.assert_close(xc, xh, rtol=0, atol=1e-4)


def test_score_chain_skips_through_the_skip_kernel_in_five_nodes(cuda):
    """The resident score chain with its step kernels and with its PyTorch
    segments (engaged or not by hand), from the same draws: samples, modes
    and statistics bitwise; with the kernels every skip went through the skip
    kernel (its launches are ``chain.runs.skip``), every step through pre and
    post, and a skipped step is 5 kernel nodes (pre, the branch setter, skip,
    post, the WHILE setter)."""
    from fdtpu_torch.kernels import chain_step
    from fdtpu_torch.utils import profiling

    kw, _ = GRAPH_CHAINS["score"]
    draws = _draws(2, 30)
    runs = {}
    for kernels in (True, False):
        sampler = DiffusionSampler(_graph_model(), 4, use_cache=True, cache_kwargs=kw,
                                   batches_per_call=2)
        chain = sampler._resident_chain(30, True, True, True)
        chain.step_kernels = kernels
        sampler.sample(8, 30, **draws)  # captures
        before = (chain_step.launches_pre, chain_step.launches_skip, chain_step.launches_post)
        with profiling.recording():
            x = sampler.sample(8, 30, **draws)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(
            (chain_step.launches_pre, chain_step.launches_skip, chain_step.launches_post),
            before))
        loop = chain.loop
        skip_nodes = (loop.setters[-1] + loop.pre.launched[-1] + loop.branches[0].launched[-1]
                      + loop.post.launched[-1])
        runs[kernels] = (x, sampler.last_modes, sampler.get_cache_stats(),
                         profiling.export()["counters"], launched, skip_nodes)
    x1, m1, s1, counters, launched, nodes = runs[True]
    x0, m0, s0, _, launched0, nodes0 = runs[False]
    assert counters["chain.steps"] == 60 and counters["chain.runs.skip"] > 0
    assert launched == (60, counters["chain.runs.skip"], 60) and launched0 == (0, 0, 0)
    assert nodes == 5 and nodes0 > 8, (nodes, nodes0)
    assert torch.equal(m1, m0) and s1 == s0
    assert torch.equal(x1, x0), f"samples differ by {float((x1 - x0).abs().max()):.3g}"


# ------------------------------------------------------------- DiT-XL/2
def _dit(cuda):
    """DiT-XL/2 at its published widths (``portbench/configs/dit-xl-droughts365.json``),
    the benchmark cell's weights, and the model on the card."""
    from portbench import common
    from portbench.entries import sample_dit
    from portbench.weights_dit import make_weights

    _, _, config = common.cell_files("dit-xl-droughts365-sample-score")
    m = config["model"]
    w = make_weights(m, common.sub_seed(config["weights_seed"], "weights"), "cuda")
    return sample_dit.score_model(config, w, "cuda", 1000), w, m


def test_dit_forward_at_published_widths_matches_the_reference(cuda):
    """A forward at batch 32 over 365 × 13 against ``portbench/reference/dit.py``
    in blocks of 8 rows, both float32 with TF32 off: relative L2 per block
    under 1e-5 (the two differ in the order of float32 sums: the einsum
    attention against the materialised one, the fused LayerNorm and GELU),
    where the reference in TF32 is ~1e-3 away."""
    from portbench.reference import dit
    from portbench.reference.model import precision

    model, w, m = _dit(cuda)
    x = torch.randn((32, 365, 13), generator=cuda, device="cuda")
    t = torch.rand((32,), generator=cuda, device="cuda")
    with torch.no_grad():
        got = model.network(x, t)
        for lo in range(0, 32, 8):
            rows = slice(lo, lo + 8)
            with precision(False):
                want = dit.score(w, m, x[rows], t[rows])
            with precision(True):
                tf32 = dit.score(w, m, x[rows], t[rows])
            gap = float((got[rows] - want).norm() / want.norm())
            control = float((tf32 - want).norm() / want.norm())
            assert gap < 1e-5 < 10 * 1e-5 < control, (lo, gap, control)


@pytest.mark.filterwarnings("ignore:E2-CRF error-budget guard")
def test_dit_resident_score_chain_equals_the_eager_one(cuda):
    """The cell's score level on DiT-XL/2, 2 batches of 32, 200 steps: the
    resident chain (one graph replay a trajectory, the step kernels) against
    the eager loop from the same draws: samples, modes and statistics
    bitwise, and both refreshes and skips taken."""
    model, _, _ = _dit(cuda)
    kw = {"level": "score", "R": 100, "tau_0": 1.35, "eps_order": 1}
    g = torch.Generator(device="cuda").manual_seed(7)
    draws = dict(prior_noise=torch.randn((64, 365, 13), generator=g, device="cuda"),
                 step_noise=torch.randn((200, 64, 365, 13), generator=g, device="cuda"))
    out = {}
    for per_call in (1, 2):
        sampler = DiffusionSampler(model, 32, use_cache=True, cache_kwargs=kw,
                                   batches_per_call=per_call)
        out[per_call] = (sampler.sample(64, 200, **draws), sampler.last_modes,
                         sampler.get_cache_stats())
    (x1, m1, s1), (x2, m2, s2) = out[1], out[2]
    assert torch.equal(m1, m2) and s1 == s2
    assert torch.equal(x1, x2), f"samples differ by {float((x1 - x2).abs().max()):.3g}"
    assert 0 < int(m1.sum()) < m1.numel()


def test_dit_block_kernels_fall_under_the_three_ranges(cuda):
    """One DiT-XL/2 block (published widths, batch 4) profiled on the card:
    every device operation it runs lies inside the device-side annotation
    of ``fdtpu.dit.attention``, ``.mlp`` or ``.modulation``
    (``portbench/ranges.py``); none lies outside them.  It runs in a fresh
    process: earlier tests of this file that profile conditional graphs can
    leave the process's profiler recording no device activity at all."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import json, sys, torch\n"
        "sys.path.insert(0, '.')\n"
        "from fdtpu_torch.models import ScoreModelConfig, init_score_model\n"
        "from portbench import ranges\n"
        "from portbench.entries.sample_dit import RANGES\n"
        "from portbench.trace import profile\n"
        "torch.backends.cuda.matmul.allow_tf32 = False\n"
        "cfg = ScoreModelConfig(n_channels=13, max_len=365, d_model=1152, num_layers=1,\n"
        "                       n_head=16, dim_feedforward=4608, ln_eps=1e-6, dropout=0.0,\n"
        "                       backbone='dit', attention_impl='auto')\n"
        "block = init_score_model(cfg, device='cuda').backbone[0]\n"
        "g = torch.Generator(device='cuda').manual_seed(0)\n"
        "h = torch.randn((4, 365, 1152), generator=g, device='cuda')\n"
        "c = torch.randn((4, 1152), generator=g, device='cuda')\n"
        "with torch.no_grad():\n"
        "    block(h, c)\n"
        "    prof = profile(lambda: block(h, c), torch.device('cuda'))\n"
        "found = ranges.device_seconds(prof, RANGES)\n"
        "print(json.dumps({str(k): v for k, v in found.items()}))\n")
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    found = json.loads(out.strip().splitlines()[-1])
    assert set(found) == {"fdtpu.dit.attention", "fdtpu.dit.mlp", "fdtpu.dit.modulation"}, found
    assert all(v > 0 for v in found.values()), found
