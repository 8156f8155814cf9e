"""The shapes the block-diagonal attention kernels B1 and B2 take, checked
on the CPU through the wrappers' input checks on ``meta`` tensors.

Before the one-pass designs, both kernels staged two (Dh, T) float32 slabs of
one (batch, head) in shared memory, so they took 2·4·Dh·T ≤ 232,448 bytes:
T ≤ 4,842 at Dh 6, 908 at Dh 32, 29,056 at Dh 1.  Every such shape must still
be taken; the first T past the new ceiling must raise ``ValueError``.
"""

import pytest
import torch

from fdtpu_torch.kernels import blockdiag_attention as bda

EARLIER_SMEM = 232_448
KERNELS = ["blockdiag_mha", "blockdiag_mha_bwd"]


def earlier_max_t(dh: int) -> int:
    return EARLIER_SMEM // (2 * 4 * dh)


def meta_inputs(b, t, h, dh, dtype=torch.float32):
    q = torch.empty((b, t, h * dh), device="meta", dtype=dtype)
    k = torch.empty((b, h, dh, t), device="meta", dtype=dtype)
    v = torch.empty((b, h, t, dh), device="meta", dtype=dtype)
    return q, k, v, torch.empty_like(q)


def check(name, q, k, v, g):
    tensors = (q, k, v) if name == "blockdiag_mha" else (q, k, v, g)
    bda._check_kernel_inputs(name, *tensors)


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("dh", range(1, 33))
def test_every_shape_the_earlier_kernels_took_is_still_taken(name, dh):
    top = earlier_max_t(dh)
    for t in (1, 187, top // 2, top):
        check(name, *meta_inputs(2, t, 3, dh))


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("dh", [1, 2, 6, 8, 16, 32])
def test_first_shape_past_the_ceiling_raises(name, dh):
    check(name, *meta_inputs(1, bda.MAX_SEQ, 1, dh))
    with pytest.raises(ValueError, match=f"T <= {bda.MAX_SEQ}"):
        check(name, *meta_inputs(1, bda.MAX_SEQ + 1, 1, dh))


@pytest.mark.parametrize("name", KERNELS)
def test_bfloat16_is_taken_at_the_main_shape_and_the_ceiling(name):
    check(name, *meta_inputs(128, 187, 12, 6, dtype=torch.bfloat16))
    check(name, *meta_inputs(1, bda.MAX_SEQ, 1, 6, dtype=torch.bfloat16))


def test_ceiling_is_above_every_earlier_shape():
    assert bda.MAX_SEQ >= max(earlier_max_t(dh) for dh in range(1, 33)) == 29_056


@pytest.mark.parametrize("name", KERNELS)
def test_other_limits_still_raise(name):
    with pytest.raises(ValueError, match="head_dim"):
        check(name, *meta_inputs(1, 8, 1, bda.MAX_HEAD_DIM + 1))
    with pytest.raises(TypeError):
        check(name, *meta_inputs(1, 8, 1, 6, dtype=torch.float64))
    with pytest.raises(ValueError, match="65535"):
        check(name, *meta_inputs(65536, 8, 1, 6))
    q, k, v, g = meta_inputs(1, 8, 2, 6)
    with pytest.raises(ValueError, match="contiguous"):
        check(name, q, k.transpose(2, 3).contiguous().transpose(2, 3), v, g)

