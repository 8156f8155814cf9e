"""The score network's weights, made on the device from the seed.

The torch-default initialisation that FourierDiffusion trains from (the
reference's ``nn.Linear``, ``nn.Embedding`` and ``nn.MultiheadAttention``):
a Linear's weight and bias U(±1/√fan_in), the attention in-projection
xavier-uniform with zero in- and out-projection biases, the positional table
N(0, 1), the time encoding's frozen frequencies N(0, 1)·``gfp_scale``,
LayerNorm ones and zeros.  Every uniform comes from one ``torch.rand`` call
and every normal from one ``torch.randn`` call of a generator on the device,
so the set-up makes the weights in two large calls.  Names are the port's
``state_dict`` keys; both the program and the plain reference are handed
these tensors."""

from __future__ import annotations

import math

import torch


def leaves(model: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """``(name, shape, kind, scale)`` of every tensor, ``kind`` one of
    ``uniform`` (U(±scale)), ``normal`` (N(0, 1)·scale), ``ones``, ``zeros``."""
    c, t, d = model["n_channels"], model["max_len"], model["d_model"]
    f = model["dim_feedforward"]

    def linear(name, n_in, n_out, bias="uniform"):
        b = 1.0 / math.sqrt(n_in)
        return [(f"{name}.weight", (n_out, n_in), "uniform", b),
                (f"{name}.bias", (n_out,), bias, b)]

    out = linear("embedder", c, d)
    out.append(("pos_encoder.embedding", (t, d), "normal", 1.0))
    out.append(("time_encoder.W", ((d + 1) // 2,), "normal", float(model["gfp_scale"])))
    out += linear("time_encoder.dense", d, d)
    for i in range(model["num_layers"]):
        p = f"backbone.{i}."
        out.append((p + "in_proj_weight", (3 * d, d), "uniform", math.sqrt(6.0 / (4 * d))))
        out.append((p + "in_proj_bias", (3 * d,), "zeros", 0.0))
        out += linear(p + "out_proj", d, d, bias="zeros")
        out += linear(p + "linear1", d, f)
        out += linear(p + "linear2", f, d)
        for norm in ("norm1", "norm2"):
            out += [(p + norm + ".weight", (d,), "ones", 0.0),
                    (p + norm + ".bias", (d,), "zeros", 0.0)]
    out += linear("unembedder", d, c)
    return out


@torch.no_grad()
def make_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The network's tensors from ``seed``, float32 on ``device``."""
    spec = leaves(model)
    n_uniform = sum(math.prod(s) for _, s, k, _ in spec if k == "uniform")
    n_normal = sum(math.prod(s) for _, s, k, _ in spec if k == "normal")
    g = torch.Generator(device=device).manual_seed(seed)
    uniform = torch.rand((n_uniform,), generator=g, device=device).mul_(2.0).sub_(1.0)
    normal = torch.randn((n_normal,), generator=g, device=device)
    out, iu, i_n = {}, 0, 0
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        if kind == "uniform":
            out[name] = uniform[iu:iu + n].view(shape) * scale
            iu += n
        elif kind == "normal":
            out[name] = normal[i_n:i_n + n].view(shape) * scale
            i_n += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
