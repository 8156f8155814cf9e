"""Least time of one call of the attention kernels, from their shapes.

B1 (``blockdiag_mha``, the forward of full attention) and B4 (``fused_mha``,
queries against stored keys): q, k, v read once and the output written once,
against 4·B·H·Tq·Tk·Dh FLOPs of scores and values at the input type's peak
plus B·H·Tq·Tk exponentials counted at the float32 rate.  B2
(``blockdiag_mha_bwd``): q, k, v and the output's cotangent read once and
dq, dk, dv written once, against the five products' 10·B·H·T²·Dh FLOPs plus
B·H·T² exponentials.  Exponentials at the float32 FMA rate err low (the
special-function unit is slower), so a share from these bounds cannot pass
100% unless the operations or bytes were counted too high.

Each function returns ``(seconds, what binds)``, ``what`` being
``"operations"`` or ``"bytes"``."""

from __future__ import annotations

from portbench.flops.peaks import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_HBM_BYTES


def _bound(n_bytes: float, flops: float, exps: float, bf16: bool) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_HBM_BYTES
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS) + exps / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def attention_bound_s(batch: int, seq: int, n_head: int, head_dim: int, itemsize: int = 4,
                      bf16: bool = False, kv_len: int | None = None) -> tuple[float, str]:
    """One forward attention call (B1, or B4 with ``kv_len`` keys) of ``seq``
    query rows."""
    kv_len = seq if kv_len is None else kv_len
    n_bytes = 2 * batch * (seq + kv_len) * n_head * head_dim * itemsize
    flops = 4 * batch * n_head * seq * kv_len * head_dim
    exps = batch * n_head * seq * kv_len
    return _bound(n_bytes, flops, exps, bf16)


def attention_bwd_bound_s(batch: int, seq: int, n_head: int, head_dim: int, itemsize: int = 4,
                          bf16: bool = False) -> tuple[float, str]:
    """One backward call of full attention (B2)."""
    n_bytes = 7 * batch * seq * n_head * head_dim * itemsize
    flops = 10 * batch * n_head * seq * seq * head_dim
    exps = batch * n_head * seq * seq
    return _bound(n_bytes, flops, exps, bf16)
