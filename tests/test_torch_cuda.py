"""Card-only tests of the port's CUDA kernels (forward B1, backward B2) and
of the autograd Function over them (B3), held against their plain PyTorch
versions on the card.  They skip without a CUDA device.

This file imports only torch and the port, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: atol 2e-4 in float32 (the bound tests/test_kernels.py holds the
Pallas kernel to), 5e-2 for bfloat16 inputs against the float32 plain version.
"""

import pytest
import torch

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
