"""The DiT score network's weights, made on the device from the seed.

DiT's ``initialize_weights`` (``models.py`` of facebookresearch/DiT): every
Linear xavier-uniform with a zero bias, the patch embedding (here
Linear(C → D)) likewise, the time MLP's weights N(0, 0.02); but the adaLN
modulations and the final layer's projection are drawn xavier-uniform
instead of zero, since zero gives an output of 0 everywhere (departure 5 of
``reference/dit.py``).  The sin-cos positions are fixed, not weights.  As in
``weights.py``, every uniform comes from one ``torch.rand`` call and every
normal from one ``torch.randn`` call of a generator on the device; the
tensors are views of those two buffers.  Names are the program's
``state_dict`` keys; the program and the plain reference are handed these
tensors."""

from __future__ import annotations

import math

import torch


def leaves(model: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """``(name, shape, kind, scale)`` of every tensor, ``kind`` one of
    ``uniform`` (U(±scale)), ``normal`` (N(0, 1)·scale) or ``zeros``."""
    c, d, f = model["n_channels"], model["d_model"], model["dim_feedforward"]

    def linear(name, n_in, n_out, kind="uniform"):
        scale = 0.02 if kind == "normal" else math.sqrt(6.0 / (n_in + n_out))
        return [(f"{name}.weight", (n_out, n_in), kind, scale), (f"{name}.bias", (n_out,),
                                                                  "zeros", 0.0)]

    out = linear("embedder", c, d)
    out += linear("time_embedder.linear1", 256, d, "normal")
    out += linear("time_embedder.linear2", d, d, "normal")
    for i in range(model["num_layers"]):
        p = f"backbone.{i}."
        out += linear(p + "modulation", d, 6 * d)
        out += linear(p + "qkv", d, 3 * d)
        out += linear(p + "proj", d, d)
        out += linear(p + "fc1", d, f)
        out += linear(p + "fc2", f, d)
    out += linear("final_layer.modulation", d, 2 * d)
    out += linear("final_layer.linear", d, c)
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
    out, at = {}, {"uniform": 0, "normal": 0}
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
            continue
        buf = uniform if kind == "uniform" else normal
        out[name] = buf[at[kind]:at[kind] + n].view(shape).mul_(scale)
        at[kind] += n
    return out
