"""The encoder layer's FFN tail through ``fdtpu::ffn_block`` on the CPU
(``fdtpu_torch/kernels/ffn.py``; kernel F1 runs only on the card, in
tests/test_torch_cuda.py).

The operator's CPU implementation is the layer's composition op for op, so
on the CPU it equals the tail that ``EncoderLayer._block`` composed before
the operator existed, written out here, bitwise.  ``_block`` takes the
operator exactly when no dropout acts, no gradient is recorded, there is no
model axis and the compute dtype is float32 at a width F1 takes; every other
call composes the tail itself (the operator's calls counted by a dispatch
mode).  The exported program's tests are in tests/test_torch_export.py.
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from fdtpu_torch.dist.parallel import Axis
from fdtpu_torch.kernels import ffn
from fdtpu_torch.models import ScoreModelConfig, init_score_model
from fdtpu_torch.models.transformer import EncoderLayer

# The published width (d_model 72, 12 heads, FFN 2048), at ecg187's and
# droughts365's full-forward rows and the token level's TOPK rows (24 a
# series), two series each; and the tests' small width.
SHAPES = {
    "ecg187-full": (72, 12, 2048, 187),
    "droughts365-full": (72, 12, 2048, 365),
    "topk": (72, 12, 2048, 24),
    "small": (12, 2, 24, 17),
}
BATCH = 2


class CountOp(TorchDispatchMode):
    """Counts calls of ``torch.ops.fdtpu.ffn_block``."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.fdtpu.ffn_block.default:
            self.calls += 1
        return func(*args, **(kwargs or {}))


def _old_norm(x, norm):
    """``LayerNorm.forward`` as written before ``ffn.layer_norm``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + norm.eps)
    return normed.to(x.dtype) * norm.weight.to(x.dtype) + norm.bias.to(x.dtype)


def _old_tail(layer, x):
    """The FFN tail ``_block`` composed without dropout before the operator."""
    w = {n: getattr(layer, n) for n in ("linear1", "linear2")}
    ff = torch.relu(F.linear(x, w["linear1"].weight.to(x.dtype), w["linear1"].bias.to(x.dtype)))
    ff = F.linear(ff, w["linear2"].weight.to(x.dtype), w["linear2"].bias.to(x.dtype))
    return _old_norm(x + ff, layer.norm2)


def _layer(d, h, f, dropout=0.1, seed=0):
    layer = EncoderLayer(d, h, f, dropout=dropout)
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    # Non-trivial LayerNorm parameters, so the scale and shift show.
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed + 1)
        for norm in (layer.norm1, layer.norm2):
            norm.weight.add_(0.1 * torch.randn(d, generator=g))
            norm.bias.add_(0.1 * torch.randn(d, generator=g))
    return layer


def _rows(d, t, seed=2):
    return torch.randn((BATCH, t, d), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_operator_on_the_cpu_is_the_old_tail_bitwise(shape):
    d, h, f, t = SHAPES[shape]
    layer = _layer(d, h, f)
    x = _old_norm(_rows(d, t), layer.norm1)
    with torch.no_grad():
        got = ffn.ffn_block(x, layer.linear1.weight, layer.linear1.bias, layer.linear2.weight,
                            layer.linear2.bias, layer.norm2.weight, layer.norm2.bias,
                            layer.norm2.eps)
        want = _old_tail(layer, x)
    assert got.shape == x.shape and got.dtype == x.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_block_through_the_operator_equals_the_composed_block_bitwise(shape):
    d, h, f, t = SHAPES[shape]
    layer = _layer(d, h, f)
    x, attn = _rows(d, t, 3), _rows(d, t, 4)
    composed = layer._block(x, attn).detach()  # gradients recorded: the composition
    with torch.no_grad(), CountOp() as count:
        got = layer._block(x, attn)
    assert count.calls == 1
    assert torch.equal(got, composed)


def _identity(x, group):
    return x


# Each case: (layer dropout, train, with a generator, grad enabled, model axis,
# dtype, width) and whether the operator is taken.
ROUTES = {
    "sampling": (0.1, False, False, False, False, torch.float32, 12, True),
    "train-without-generator": (0.1, True, False, False, False, torch.float32, 12, True),
    "train-at-rate-0": (0.0, True, True, False, False, torch.float32, 12, True),
    "published-width": (0.1, False, False, False, False, torch.float32, 72, True),
    "train-with-generator": (0.1, True, True, False, False, torch.float32, 12, False),
    "grad-enabled": (0.1, False, False, True, False, torch.float32, 12, False),
    "model-axis": (0.1, False, False, False, True, torch.float32, 12, False),
    "bfloat16": (0.1, False, False, False, False, torch.bfloat16, 12, False),
    "past-the-kernel's-width": (0.1, False, False, False, False, torch.float32, 80, False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_block_takes_the_operator_exactly_without_dropout_gradient_axis_or_bf16(
        case, monkeypatch):
    dropout, train, with_gen, grad, axis, dtype, d, routed = ROUTES[case]
    layer = _layer(d, 2, 2 * d, dropout=dropout)
    if axis:
        # A model axis of one rank: its collectives are the identity.
        from fdtpu_torch.dist import tensor_parallel

        monkeypatch.setattr(tensor_parallel, "copy_to_model", _identity)
        monkeypatch.setattr(tensor_parallel, "reduce_from_model", _identity)
        layer.model_axis = Axis(group=None, size=1, index=0)
    x, attn = _rows(d, 9, 5).to(dtype), _rows(d, 9, 6).to(dtype)
    gen = torch.Generator().manual_seed(7) if with_gen else None
    with torch.set_grad_enabled(grad), CountOp() as count:
        got = layer._block(x, attn, train=train, generator=gen)
        decided = layer._ffn_kernel(x, layer._ffn_params(), train, gen)
    assert count.calls == int(routed)
    assert decided is routed
    if routed:
        # The composed tail on the same norm1 output, drawn the same way.
        gen = torch.Generator().manual_seed(7) if with_gen else None
        with torch.enable_grad():
            want = layer._block(x, attn, train=train, generator=gen).detach()
        assert torch.equal(got, want)


def test_network_forward_calls_the_operator_once_a_layer_only_without_gradients():
    cfg = ScoreModelConfig(n_channels=2, max_len=16, d_model=12, num_layers=3, n_head=2,
                           dim_feedforward=24)
    net = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    x, t = torch.randn((4, 16, 2), generator=g), torch.rand((4,), generator=g)
    with torch.no_grad(), CountOp() as count:
        sampled = net(x, t)
    assert count.calls == cfg.num_layers
    with CountOp() as count:
        trained = net(x, t)
    assert count.calls == 0
    assert torch.equal(sampled, trained.detach())


def test_operator_passes_opcheck_on_the_cpu():
    layer = _layer(12, 2, 24)
    x = _rows(12, 5)
    args = (x, layer.linear1.weight.detach(), layer.linear1.bias.detach(),
            layer.linear2.weight.detach(), layer.linear2.bias.detach(),
            layer.norm2.weight.detach(), layer.norm2.bias.detach(), layer.norm2.eps)
    torch.library.opcheck(torch.ops.fdtpu.ffn_block.default, args)


def test_wrapper_refuses_inconsistent_shapes_and_dtypes():
    layer = _layer(12, 2, 24)
    w = [layer.linear1.weight, layer.linear1.bias, layer.linear2.weight, layer.linear2.bias,
         layer.norm2.weight, layer.norm2.bias]
    x = _rows(12, 5)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        ffn.ffn_block(x[..., :10], *w, 1e-5)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        ffn.ffn_block(x, w[0], w[1], w[2].t(), *w[3:], 1e-5)
    with pytest.raises(TypeError, match="dtype"):
        ffn.ffn_block(x.double(), *w, 1e-5)
    # On the CPU the operator never launches the kernel.
    before = ffn.launches
    with torch.no_grad():
        ffn.ffn_block(x, *w, 1e-5)
    assert ffn.launches == before
