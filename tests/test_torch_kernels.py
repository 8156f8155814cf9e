"""Port parity: the block-diagonal attention kernel's plain version and its
wrapper's CPU routing, against the JAX package's Pallas kernel (interpret
mode on the CPU) and its XLA reference.

Tolerances: atol 2e-4 in float32, the bound tests/test_kernels.py holds the
Pallas kernel to; 5e-2 for bfloat16 inputs against the float32 reference.
The CUDA kernel itself is held against this plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.kernels.blockdiag_attention import blockdiag_mha as jax_kernel
from fdtpu.kernels.blockdiag_attention import blockdiag_mha_reference
from fdtpu_torch.kernels import blockdiag_attention as bda


def _inputs(b, t, h, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, t, h * dh)).astype(np.float32),
        rng.standard_normal((b, h, dh, t)).astype(np.float32),
        rng.standard_normal((b, h, t, dh)).astype(np.float32),
    )


def _port(q, k, v, dtype=torch.float32, shift=True):
    return bda.blockdiag_mha_plain(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), shift=shift
    )


@pytest.mark.parametrize(
    "shape, q_tile",
    [((4, 20, 3, 6), 128), ((2, 1024, 4, 8), 256)],
    ids=["batch-regime", "query-tiled-regime"],
)
def test_plain_matches_pallas_interpret_and_reference(shape, q_tile):
    q, k, v = _inputs(*shape)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = _port(q, k, v).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_kernel(jq, jk, jv, q_tile=q_tile, interpret=True)), atol=2e-4
    )
    np.testing.assert_allclose(got, np.asarray(blockdiag_mha_reference(jq, jk, jv)), atol=2e-4)


def test_plain_bf16_inputs_against_float32_reference():
    q, k, v = _inputs(2, 20, 3, 6)
    got = _port(q, k, v, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(blockdiag_mha_reference(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=5e-2)
    pallas = jax_kernel(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), interpret=True)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(pallas, np.float32), atol=5e-2
    )


def test_plain_noshift_matches_pallas_noshift():
    q, k, v = _inputs(2, 16, 2, 6)
    got = _port(q, k, v, shift=False).numpy()
    want = np.asarray(jax_kernel(*map(jnp.asarray, (q, k, v)), interpret=True, shift=False))
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, _port(q, k, v).numpy(), atol=1e-5)


def test_plain_moderately_negative_scores_match_pallas():
    """Real scores ≈ −22 in every row: the padded columns of the Pallas
    kernel lift its row max to 0, the port shifts by the real max; both
    denominators stay above the 1e-30 clamp and the outputs agree."""
    b, t, h, dh = 2, 20, 3, 6
    q = np.full((b, t, h * dh), 3.0, np.float32)
    k = np.full((b, h, dh, t), -3.0, np.float32)
    v = _inputs(b, t, h, dh, seed=2)[2]
    got = _port(q, k, v).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(got, np.asarray(jax_kernel(jq, jk, jv, interpret=True)), atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(blockdiag_mha_reference(jq, jk, jv)), atol=2e-4)


def test_plain_all_underflow_is_finite_and_the_true_average():
    """Every real score ≈ −6100: the Pallas kernel (max lifted to 0 by its
    padding) underflows to the clamp and returns 0; the port's max is over
    the real keys, so it returns the exact softmax — here the mean of v."""
    b, t, h, dh = 2, 20, 3, 6
    q = np.full((b, t, h * dh), 50.0, np.float32)
    k = np.full((b, h, dh, t), -50.0, np.float32)
    v = _inputs(b, t, h, dh, seed=2)[2]
    got = _port(q, k, v).numpy()
    assert np.isfinite(got).all()
    mean_v = v.mean(axis=2)  # (B, H, Dh): equal scores → uniform weights
    want = np.broadcast_to(mean_v[:, None], (b, t, h, dh)).reshape(b, t, h * dh)
    np.testing.assert_allclose(got, want, atol=1e-5)
    pallas = np.asarray(jax_kernel(*map(jnp.asarray, (q, k, v)), interpret=True))
    assert np.isfinite(pallas).all() and np.abs(pallas).max() == 0.0


def test_wrapper_routes_cpu_tensors_to_plain_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 16, 2, 6))
    before = bda.launches
    out = bda.blockdiag_mha(q, k, v)
    assert bda.launches == before
    torch.testing.assert_close(out, bda.blockdiag_mha_plain(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize(
    "shapes",
    [
        ((2, 16, 12), (2, 2, 6, 15), (2, 2, 16, 6)),  # k's T differs
        ((2, 16, 12), (2, 2, 6, 16), (2, 2, 16, 5)),  # v's Dh differs
        ((2, 16, 13), (2, 2, 6, 16), (2, 2, 16, 6)),  # D != H·Dh
        ((2, 16), (2, 2, 6, 16), (2, 2, 16, 6)),  # q not (B, T, D)
    ],
)
def test_wrapper_rejects_inconsistent_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        bda.blockdiag_mha(q, k, v)


def test_wrapper_rejects_mixed_dtypes():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 16, 2, 6))
    with pytest.raises(TypeError):
        bda.blockdiag_mha(q, k.to(torch.bfloat16), v)
