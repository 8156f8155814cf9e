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


@pytest.mark.parametrize("name", ["uncached", "score", "token"])
def test_exported_flagship_program_equals_the_sampler(cuda, tmp_path, name):
    """The flagship's program (d_model 72, 10 layers, 12 heads, 187 tokens;
    a batch of 128, 50 steps) exported, reloaded and run from a generator:
    bitwise the eager loop's first batch and the resident chain's from the
    same generator, with B1 launched 10 times a full forward and B4 10 times
    a TOPK step of the sampler's chain."""
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
    assert launched == (10 * full, 10 * stats["mixed_steps"] if name == "token" else 0)
