"""The shapes the attention kernels B1, B2 and B4 take, checked on the CPU
through the wrappers' input checks on ``meta`` tensors.

Before the one-pass designs, B1 and B2 staged two (Dh, T) float32 slabs of
one (batch, head) in shared memory, so they took 2·4·Dh·T ≤ 232,448 bytes:
T ≤ 4,842 at Dh 6, 908 at Dh 32, 29,056 at Dh 1.  B4's first design staged
one head's K and V slabs (odd leading dimension) and a 32-row query tile:
4·Dh·(2·(Tk|1) + 32) ≤ 232,448 bytes, any Tq.  Every such shape must still be
taken; the first T (Tk) past the new ceiling must raise ``ValueError``.
"""

import pytest
import torch

from fdtpu_torch.kernels import attention as mha
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



# B4 (fused_mha): q (B, Tq, H, Dh), k and v (B, Tk, H, Dh).


def earlier_mha_takes(tk: int, dh: int) -> bool:
    return tk >= 1 and 4 * dh * (2 * (tk | 1) + 32) <= EARLIER_SMEM


def earlier_mha_max_tk(dh: int) -> int:
    top = (EARLIER_SMEM // (4 * dh) - 32) // 2  # the largest Tk | 1
    return top if top % 2 else top - 1


def mha_meta(b, tq, tk, h, dh, dtype=torch.float32):
    q = torch.empty((b, tq, h, dh), device="meta", dtype=dtype)
    k = torch.empty((b, tk, h, dh), device="meta", dtype=dtype)
    return q, k, torch.empty_like(k)


@pytest.mark.parametrize("dh", range(1, 33))
def test_mha_takes_every_shape_the_earlier_kernel_took(dh):
    top = earlier_mha_max_tk(dh)
    assert earlier_mha_takes(top, dh) and not earlier_mha_takes(top + 1, dh)
    assert not earlier_mha_takes(top + 2, dh)
    for tq in (1, 24, 187, 100_000):  # the last far past every Tk
        for tk in (1, 187, top // 2, top):
            mha._check_kernel_inputs(*mha_meta(2, tq, tk, 3, dh))


@pytest.mark.parametrize("dh", [1, 2, 6, 8, 16, 32])
def test_mha_first_tk_past_the_ceiling_raises(dh):
    mha._check_kernel_inputs(*mha_meta(1, 24, mha.MAX_SEQ, 1, dh))
    with pytest.raises(ValueError, match=f"Tk <= {mha.MAX_SEQ}"):
        mha._check_kernel_inputs(*mha_meta(1, 24, mha.MAX_SEQ + 1, 1, dh))


def test_mha_bfloat16_is_taken_at_both_main_shapes_and_the_ceiling():
    for shape in ((128, 24, 187, 12, 6), (128, 187, 187, 12, 6), (1, 187, mha.MAX_SEQ, 1, 6)):
        mha._check_kernel_inputs(*mha_meta(*shape, dtype=torch.bfloat16))


def test_mha_ceiling_is_above_every_earlier_shape():
    assert mha.MAX_SEQ >= max(earlier_mha_max_tk(dh) for dh in range(1, 33)) == 29_039


@pytest.mark.parametrize("case", ["head_dim", "dtype", "strided", "batch", "heads", "no_keys"])
def test_mha_other_limits_still_raise(case):
    q, k, v = mha_meta(1, 4, 8, 2, 6)
    error, match = ValueError, None
    if case == "head_dim":
        q, k, v = mha_meta(1, 4, 8, 1, mha.MAX_HEAD_DIM + 1)
        match = "head_dim"
    elif case == "dtype":
        q, k, v = mha_meta(1, 4, 8, 1, 6, dtype=torch.float64)
        error = TypeError
    elif case == "strided":
        q, _, v = mha_meta(2, 4, 8, 2, 6)
        k = torch.empty((8, 2, 2, 6), device="meta").transpose(0, 1)  # (B, Tk, H, Dh) strided
        match = "contiguous"
    elif case == "batch":
        q, k, v = mha_meta(65536, 4, 8, 1, 6)
        match = "65535"
    elif case == "heads":
        q, k, v = mha_meta(1, 4, 8, 65536, 1)
        match = "65535"
    else:
        q, k, v = mha_meta(1, 4, 0, 1, 6)
        match = "1 <= Tk"
    with pytest.raises(error, match=match):
        mha._check_kernel_inputs(q, k, v)
