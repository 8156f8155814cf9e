"""Operations of the DiT score network (``reference/dit.py``), from its
shapes.

Counted: every matrix product at 2 FLOPs a multiply-add.  A token, per
block: the qkv projection (6·D²), the scores and values against all T
tokens (4·T·D, all heads), the output projection (2·D²) and the MLP's two
products (4·D·F; 16·D² at DiT's F = 4D), so 24·D² + 4·T·D at F = 4D; a
sample, per block, the adaLN modulation Linear(D, 6D) (12·D²).  Once: the
embedding (2·C·D a token), the time MLP (2·256·D + 2·D² a sample), the
final layer's modulation (4·D² a sample) and projection (2·D·C a token).
Not counted: element-wise work (LayerNorm, modulate, gates, residuals,
softmax, GELU, SiLU, the sinusoids)."""

from __future__ import annotations

FREQ_FEATURES = 256


def forward_flops_per_row(seq: int, n_channels: int, d_model: int, num_layers: int,
                          dim_feedforward: int) -> int:
    """FLOPs of one full forward of one series of ``seq`` tokens."""
    t, c, d, f = seq, n_channels, d_model, dim_feedforward
    token = (2 * d * 3 * d      # qkv
             + 2 * t * d        # scores, all heads
             + 2 * t * d        # values, all heads
             + 2 * d * d        # proj
             + 2 * 2 * d * f)   # fc1, fc2
    modulation = 2 * d * 6 * d
    once = (2 * t * c * d                                  # embedding
            + 2 * FREQ_FEATURES * d + 2 * d * d            # time MLP
            + 2 * d * 2 * d + 2 * t * d * c)               # final layer
    return num_layers * (t * token + modulation) + once


def model_forward_flops(model: dict, rows: int) -> int:
    """:func:`forward_flops_per_row` of a configuration file's ``model`` for
    ``rows`` series."""
    return rows * forward_flops_per_row(model["max_len"], model["n_channels"], model["d_model"],
                                        model["num_layers"], model["dim_feedforward"])
