"""Port parity: the block-diagonal attention backward (B2) and its autograd
glue (B3) against the JAX package's Pallas backward (interpret mode on the
CPU), its long-sequence fallback and ``jax.vjp`` of its XLA reference.

Tolerances: atol 2e-5 in float32, the bound tests/test_kernels.py holds the
Pallas backward to; 5e-2 for bfloat16 inputs (the Pallas kernel rounds dS
and W to bfloat16, the plain version does not); 1e-3 for gradients of a
squared-output loss through the custom VJP, as tests/test_kernels.py does.
The CUDA kernel itself is held against this plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.kernels import blockdiag_attention as jax_bda
from fdtpu_torch.kernels import blockdiag_attention as bda


def _inputs(b, t, h, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, t, h * dh)).astype(np.float32),
        rng.standard_normal((b, h, dh, t)).astype(np.float32),
        rng.standard_normal((b, h, t, dh)).astype(np.float32),
        rng.standard_normal((b, t, h * dh)).astype(np.float32),
    )


def _port_bwd(arrays, dtype=torch.float32):
    return bda.blockdiag_mha_bwd_plain(*(torch.from_numpy(a).to(dtype) for a in arrays))


def _reference_vjp(q, k, v, g):
    _, vjp = jax.vjp(jax_bda.blockdiag_mha_reference, *map(jnp.asarray, (q, k, v)))
    return vjp(jnp.asarray(g))


@pytest.mark.parametrize("shape", [(2, 20, 3, 6), (1, 600, 12, 6)],
                         ids=["batch-regime", "long-T-fallback"])
def test_bwd_plain_matches_pallas_interpret_and_reference_vjp(shape):
    arrays = _inputs(*shape)
    got = _port_bwd(arrays)
    pallas = jax_bda.blockdiag_mha_bwd(*map(jnp.asarray, arrays), interpret=True)
    for name, p, j, r in zip(("dq", "dk", "dv"), got, pallas, _reference_vjp(*arrays)):
        assert p.shape == j.shape, name
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=2e-5, err_msg=name)
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=2e-5, err_msg=name)


def test_bwd_plain_bf16_inputs_against_pallas_and_float32():
    arrays = _inputs(2, 20, 3, 6, seed=1)
    got = _port_bwd(arrays, torch.bfloat16)
    assert all(a.dtype == torch.bfloat16 for a in got)
    pallas = jax_bda.blockdiag_mha_bwd(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                                       interpret=True)
    for p, j, r in zip(got, pallas, _reference_vjp(*arrays)):
        np.testing.assert_allclose(p.float().numpy(), np.asarray(j, np.float32), atol=5e-2)
        np.testing.assert_allclose(p.float().numpy(), np.asarray(r), atol=5e-2)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX custom VJP's forward and backward through Pallas interpret
    mode, as tests/test_kernels.py runs them on the CPU."""
    fwd, bwd = jax_bda.blockdiag_mha, jax_bda.blockdiag_mha_bwd
    monkeypatch.setattr(
        jax_bda, "blockdiag_mha",
        lambda q, k, v, q_tile=256, interpret=False, shift=True: fwd(
            q, k, v, q_tile=q_tile, interpret=True, shift=shift),
    )
    monkeypatch.setattr(
        jax_bda, "blockdiag_mha_bwd",
        lambda q, k, v, g, interpret=False: bwd(q, k, v, g, interpret=True),
    )


@pytest.mark.parametrize("shift", [True, False])
def test_trainable_gradients_match_jax_custom_vjp_and_autograd(pallas_interpret, shift):
    q, k, v, _ = _inputs(2, 16, 2, 6, seed=3)

    def jax_loss(q, k, v):
        return jnp.sum(jax_bda.blockdiag_mha_trainable(q, k, v, 256, shift) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = torch.autograd.grad((bda.blockdiag_mha_trainable(tq, tk, tv, shift) ** 2).sum(),
                              (tq, tk, tv))
    plain = torch.autograd.grad((bda.blockdiag_mha_plain(tq, tk, tv, shift) ** 2).sum(),
                                (tq, tk, tv))
    for name, p, j, a in zip(("dq", "dk", "dv"), got, want, plain):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-3, err_msg=name)
        np.testing.assert_allclose(p.numpy(), a.numpy(), atol=1e-3, err_msg=name)


def test_trainable_forward_is_the_kernel_forward():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, 16, 2, 6))
    out = bda.blockdiag_mha_trainable(q.requires_grad_(), k, v)
    torch.testing.assert_close(out.detach(), bda.blockdiag_mha(q.detach(), k, v),
                               rtol=0, atol=0)
    assert out.requires_grad


def test_bwd_wrapper_routes_cpu_tensors_to_plain_without_counting():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(2, 16, 2, 6))
    before = (bda.launches_bwd, bda.launches_trainable)
    got = bda.blockdiag_mha_bwd(q, k, v, g)
    tq = q.clone().requires_grad_()
    bda.blockdiag_mha_trainable(tq, k, v).backward(g)
    assert (bda.launches_bwd, bda.launches_trainable) == before
    for a, b in zip(got, bda.blockdiag_mha_bwd_plain(q, k, v, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(tq.grad, got[0], rtol=0, atol=0)


@pytest.mark.parametrize(
    "g_shape, g_dtype",
    [((2, 16, 11), torch.float32), ((2, 16, 12), torch.bfloat16)],
    ids=["shape", "dtype"],
)
def test_bwd_wrapper_rejects_a_mismatched_cotangent(g_shape, g_dtype):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, 16, 2, 6))
    with pytest.raises(ValueError, match="g must match q"):
        bda.blockdiag_mha_bwd(q, k, v, torch.zeros(g_shape, dtype=g_dtype))
