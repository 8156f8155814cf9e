"""Operations of the FourierDiffusion transformer score network, from its
shapes.

Counted: every matrix product at 2 FLOPs a multiply-add (the embedding, the
time encoding's dense layer, per layer the in-projection, the attention's
scores and values, the out-projection and the two FFN products, and the
unembedding).  Not counted: element-wise work (LayerNorm, softmax, ReLU,
dropout, residual adds, the sin/cos of the time encoding), which is under 1%
at the configurations' widths.  A training step is three forwards (the
forward, and a backward of two products for each forward product)."""

from __future__ import annotations


def forward_flops_per_row(seq: int, n_channels: int, d_model: int, num_layers: int,
                          dim_feedforward: int) -> int:
    """FLOPs of one full forward of one series of ``seq`` tokens."""
    t, c, d, f = seq, n_channels, d_model, dim_feedforward
    layer = (2 * t * d * 3 * d      # in-projection (q, k, v)
             + 2 * t * t * d        # scores, all heads
             + 2 * t * t * d        # values, all heads
             + 2 * t * d * d        # out-projection
             + 2 * 2 * t * d * f)   # FFN, both products
    return 2 * t * c * d + 2 * d * d + num_layers * layer + 2 * t * d * c


def training_flops_per_row(seq: int, n_channels: int, d_model: int, num_layers: int,
                           dim_feedforward: int) -> int:
    """FLOPs of one series through a training step (forward and backward)."""
    return 3 * forward_flops_per_row(seq, n_channels, d_model, num_layers, dim_feedforward)


def model_forward_flops(model: dict, rows: int) -> int:
    """:func:`forward_flops_per_row` of a configuration file's ``model`` for
    ``rows`` series."""
    return rows * forward_flops_per_row(model["max_len"], model["n_channels"], model["d_model"],
                                        model["num_layers"], model["dim_feedforward"])
