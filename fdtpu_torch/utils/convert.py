"""Carry weights from the JAX package into the port.

``load_jax_variables(network, variables)`` takes the JAX score model's
``{"params", "constants"}`` tree with numpy (or array-like) leaves — the
encoder layers stacked on a leading L axis, linear weights laid out
``(in, out)`` — and copies it into a :class:`ScoreNetwork`, transposing the
linear weights to torch's ``(out, in)``.  ``state_dict_to_jax_variables``
is the reverse, with numpy leaves, so a network trained by the port can be
held against the JAX package's parameters.  The key map is the port's own;
it mirrors ``fdtpu/utils/torch_replica.py:77-120``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from fdtpu_torch.models.score_models import ScoreNetwork


def jax_variables_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's state dict for a JAX transformer score-model tree."""
    p, c = variables["params"], variables["constants"]

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def lin(prefix: str, w, b) -> dict[str, torch.Tensor]:
        return {f"{prefix}.weight": t(w).T.contiguous(), f"{prefix}.bias": t(b)}

    sd = {
        **lin("embedder", p["embedder"]["w"], p["embedder"]["b"]),
        **lin("unembedder", p["unembedder"]["w"], p["unembedder"]["b"]),
        "pos_encoder.embedding": t(p["pos_encoder"]["embedding"]),
        "time_encoder.W": t(c["time_encoder"]["W"]),
        **lin("time_encoder.dense", p["time_encoder"]["dense_w"], p["time_encoder"]["dense_b"]),
    }
    bb = p["backbone"]
    num_layers = np.shape(bb["attn"]["in_proj_w"])[0]
    for i in range(num_layers):
        pre = f"backbone.{i}."
        sd[pre + "in_proj_weight"] = t(bb["attn"]["in_proj_w"][i]).T.contiguous()
        sd[pre + "in_proj_bias"] = t(bb["attn"]["in_proj_b"][i])
        sd.update(lin(pre + "out_proj", bb["attn"]["out_w"][i], bb["attn"]["out_b"][i]))
        sd.update(lin(pre + "linear1", bb["linear1"]["w"][i], bb["linear1"]["b"][i]))
        sd.update(lin(pre + "linear2", bb["linear2"]["w"][i], bb["linear2"]["b"][i]))
        for norm, ln in (("norm1", "ln1"), ("norm2", "ln2")):
            sd[pre + f"{norm}.weight"] = t(bb[ln]["scale"][i])
            sd[pre + f"{norm}.bias"] = t(bb[ln]["bias"][i])
    return sd


def state_dict_to_jax_variables(
    state_dict: Mapping[str, torch.Tensor],
) -> dict[str, dict[str, Any]]:
    """The JAX ``{"params", "constants"}`` tree (numpy float32 leaves,
    layers stacked on a leading axis) of a transformer score network's
    state dict."""

    def a(key: str) -> np.ndarray:
        return state_dict[key].detach().cpu().float().numpy()

    def lin(prefix: str) -> dict[str, np.ndarray]:
        return {"w": a(f"{prefix}.weight").T.copy(), "b": a(f"{prefix}.bias")}

    num_layers = len({k.split(".")[1] for k in state_dict if k.startswith("backbone.")})
    layers = []
    for i in range(num_layers):
        pre = f"backbone.{i}."
        layers.append({
            "attn": {
                "in_proj_w": a(pre + "in_proj_weight").T.copy(),
                "in_proj_b": a(pre + "in_proj_bias"),
                "out_w": a(pre + "out_proj.weight").T.copy(),
                "out_b": a(pre + "out_proj.bias"),
            },
            "linear1": lin(pre + "linear1"),
            "linear2": lin(pre + "linear2"),
            "ln1": {"scale": a(pre + "norm1.weight"), "bias": a(pre + "norm1.bias")},
            "ln2": {"scale": a(pre + "norm2.weight"), "bias": a(pre + "norm2.bias")},
        })

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(leaf[k] for leaf in leaves)) for k in leaves[0]}
        return np.stack(leaves)

    dense = lin("time_encoder.dense")
    params = {
        "embedder": lin("embedder"),
        "unembedder": lin("unembedder"),
        "pos_encoder": {"embedding": a("pos_encoder.embedding")},
        "time_encoder": {"dense_w": dense["w"], "dense_b": dense["b"]},
        "backbone": stack(*layers),
    }
    return {"params": params, "constants": {"time_encoder": {"W": a("time_encoder.W")}}}


def load_jax_variables(network: ScoreNetwork, variables: Mapping[str, Any]) -> ScoreNetwork:
    """Copy a JAX variables tree into ``network`` in place (strict: every
    key and shape must match) and return it."""
    network.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return network
