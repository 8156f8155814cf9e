"""Port parity: the token-major attention kernel's plain version (B4) and its
wrapper's CPU routing, against the JAX package's Pallas ``fused_mha``
(interpret mode on the CPU) and its XLA reference ``mha_reference``.

Tolerances: atol 1e-5 in float32 (the bound tests/test_kernels.py:38 holds the
Pallas kernel to); 5e-2 for bfloat16 inputs against the float32 reference
(the inputs and the weights round to 8 bits).  The CUDA kernel itself is held
against this plain version on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.kernels.attention import fused_mha as jax_fused_mha
from fdtpu.kernels.attention import mha_reference
from fdtpu.models.transformer import _attention as jax_attention
from fdtpu_torch.kernels import attention as mha
from fdtpu_torch.models import transformer as ptr


def _inputs(b, tq, tk, h, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, tq, h, dh)).astype(np.float32),
        rng.standard_normal((b, tk, h, dh)).astype(np.float32),
        rng.standard_normal((b, tk, h, dh)).astype(np.float32),
    )


def _plain(q, k, v, dtype=torch.float32):
    return mha.mha_plain(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)))


@pytest.mark.parametrize("shape", [(4, 20, 3, 6), (2, 17, 2, 6), (6, 9, 4, 8)])
def test_plain_matches_pallas_interpret_and_reference(shape):
    b, t, h, dh = shape
    q, k, v = _inputs(b, t, t, h, dh)
    got = _plain(q, k, v).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = jax_fused_mha(jq, jk, jv, batch_tile=2, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(mha_reference(jq, jk, jv)), atol=1e-5)


@pytest.mark.parametrize("tq, tk", [(4, 17), (1, 20), (24, 187), (9, 5)])
def test_plain_rectangular_matches_reference(tq, tk):
    """The token level's TOPK attends token_budget query rows to all T keys;
    mha_reference and the model's _attention take Tq != Tk, the Pallas
    BlockSpec does not."""
    q, k, v = _inputs(3, tq, tk, 2, 6, seed=1)
    got = _plain(q, k, v).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(got, np.asarray(mha_reference(jq, jk, jv)), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_attention(jq, jk, jv)), atol=1e-5)


def test_plain_bf16_against_float32_reference_and_pallas():
    q, k, v = _inputs(4, 20, 20, 3, 6, seed=2)
    got = _plain(q, k, v, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(mha_reference(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=5e-2)
    pallas = jax_fused_mha(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                           batch_tile=2, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas, np.float32), atol=5e-2)


def test_plain_is_the_model_attention():
    """One function, not two copies: the einsum path of the cached modes
    attends through mha_plain."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 5, 7, 2, 6, seed=3))
    layer = ptr.EncoderLayer(12, 2, 24, attention_impl="einsum")
    torch.testing.assert_close(layer._attend(q, k, v), mha.mha_plain(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["blockdiag", "blockdiag_noshift"])
def test_kernel_implementations_route_cached_attention_to_fused_mha(impl, monkeypatch):
    calls = []

    def recording(q, k, v):
        calls.append(q.shape)
        return mha.mha_plain(q, k, v)

    monkeypatch.setattr(ptr, "fused_mha", recording)
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 5, 7, 2, 6, seed=4))
    ptr.EncoderLayer(12, 2, 24, attention_impl=impl)._attend(q, k, v)
    assert calls == [q.shape]


def test_wrapper_routes_cpu_tensors_to_plain_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 4, 16, 2, 6))
    before = mha.launches
    out = mha.fused_mha(q, k, v)
    assert mha.launches == before
    assert out.shape == q.shape
    torch.testing.assert_close(out, mha.mha_plain(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize(
    "shapes",
    [
        ((2, 4, 2, 6), (2, 16, 2, 6), (2, 15, 2, 6)),  # k and v lengths differ
        ((2, 4, 2, 6), (2, 16, 3, 6), (2, 16, 3, 6)),  # H differs
        ((2, 4, 2, 6), (3, 16, 2, 6), (3, 16, 2, 6)),  # B differs
        ((2, 4, 12), (2, 16, 2, 6), (2, 16, 2, 6)),  # q not (B, T, H, Dh)
    ],
)
def test_wrapper_rejects_inconsistent_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        mha.fused_mha(q, k, v)


def test_wrapper_rejects_mixed_dtypes():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 4, 16, 2, 6))
    with pytest.raises(TypeError):
        mha.fused_mha(q, k.to(torch.bfloat16), v)
