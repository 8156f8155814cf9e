"""The counts of operations and bytes against hand counts."""

import pytest

from portbench.flops import attention, transformer
from portbench.flops.peaks import PEAK_FP32_FLOPS, PEAK_HBM_BYTES


def test_forward_flops_ecg():
    # Per layer at T 187, D 72, FFN 2048: in-projection 2·187·72·216 = 5,816,448;
    # scores and values 4·187²·72 = 10,071,072; out-projection 2·187·72·72 =
    # 1,938,816; FFN 4·187·72·2048 = 110,297,088.  Embedding and unembedding
    # 2·187·72 each, the time encoding's dense layer 2·72·72.
    layer = 5_816_448 + 10_071_072 + 1_938_816 + 110_297_088
    want = 10 * layer + 26_928 + 10_368 + 26_928
    assert transformer.forward_flops_per_row(187, 1, 72, 10, 2048) == want == 1_281_298_464


def test_forward_flops_droughts():
    layer = 2 * 365 * 72 * 216 + 4 * 365 * 365 * 72 + 2 * 365 * 72 * 72 + 4 * 365 * 72 * 2048
    want = 10 * layer + 2 * 365 * 13 * 72 * 2 + 2 * 72 * 72
    assert transformer.forward_flops_per_row(365, 13, 72, 10, 2048) == want
    assert transformer.training_flops_per_row(365, 13, 72, 10, 2048) == 3 * want
    model = dict(max_len=365, n_channels=13, d_model=72, num_layers=10, dim_feedforward=2048)
    assert transformer.model_forward_flops(model, 64) == 64 * want


def test_b1_bound_at_the_flagship():
    # B 128, T 187, 12 heads of 6, float32: 1,289,097,216 FLOPs and
    # 53,712,384 exps at 67 TFLOP/s (2.0045e-5 s) against 27,574,272 bytes
    # at 3.35 TB/s (8.23e-6 s): operations bind.
    s, what = attention.attention_bound_s(128, 187, 12, 6)
    assert what == "operations"
    assert s == pytest.approx((1_289_097_216 + 53_712_384) / PEAK_FP32_FLOPS)
    assert 27_574_272 / PEAK_HBM_BYTES < s


def test_b4_bound_at_topk():
    # 24 query rows against 187 keys: 15,556,608 bytes bind.
    s, what = attention.attention_bound_s(128, 24, 12, 6, kv_len=187)
    assert what == "bytes"
    assert s == pytest.approx(15_556_608 / PEAK_HBM_BYTES)


def test_b2_bound():
    # B 64, T 187: 10·64·12·187²·6 = 1,611,371,520 FLOPs and 26,856,192 exps.
    s, what = attention.attention_bwd_bound_s(64, 187, 12, 6)
    assert what == "operations"
    assert s == pytest.approx((1_611_371_520 + 26_856_192) / PEAK_FP32_FLOPS)
