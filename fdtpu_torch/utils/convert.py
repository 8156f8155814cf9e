"""Carry weights between the JAX package and the port.

``load_jax_variables(network, variables)`` takes the JAX score model's
``{"params", "constants"}`` tree with numpy (or array-like) leaves — the
backbone layers stacked on a leading L axis, linear weights laid out
``(in, out)`` (``x @ w``) — and copies it into a transformer, MLP or LSTM
network of the port, transposing the weights to torch's ``(out, in)``; the
LSTM's ``w_ih``/``w_hh`` ``(D, 4D)`` become ``(4D, D)`` with the gate order
(i, f, g, o) kept.  ``state_dict_to_jax_variables`` is the reverse, with
numpy leaves, so a network trained by the port can be held against the JAX
package's parameters.  The backbone is read off the tree's keys.  The key map
is the port's own; the transformer's mirrors
``fdtpu/utils/torch_replica.py:77-120``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_LSTM_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")
_LAYERNORMS = (("norm1", "ln1"), ("norm2", "ln2"))


def _backbone(tree: Mapping[str, Any]) -> str:
    if "pos_encoder" in tree:
        return "transformer"
    return "lstm" if "w_ih" in tree["backbone"] else "mlp"


def jax_variables_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's state dict for a JAX score-model tree (any backbone)."""
    p, c = variables["params"], variables["constants"]

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def lin(prefix: str, w, b) -> dict[str, torch.Tensor]:
        return {f"{prefix}.weight": t(w).T.contiguous(), f"{prefix}.bias": t(b)}

    sd = {
        **lin("embedder", p["embedder"]["w"], p["embedder"]["b"]),
        **lin("unembedder", p["unembedder"]["w"], p["unembedder"]["b"]),
        "time_encoder.W": t(c["time_encoder"]["W"]),
        **lin("time_encoder.dense", p["time_encoder"]["dense_w"], p["time_encoder"]["dense_b"]),
    }
    bb = p["backbone"]
    kind = _backbone(p)
    if kind == "lstm":
        for i in range(np.shape(bb["w_ih"])[0]):
            for name in ("w_ih", "w_hh"):
                sd[f"backbone.{i}.{name}"] = t(bb[name][i]).T.contiguous()
            for name in ("b_ih", "b_hh"):
                sd[f"backbone.{i}.{name}"] = t(bb[name][i])
        return sd
    if kind == "mlp":
        for i in range(np.shape(bb["linear1"]["w"])[0]):
            for name in ("linear1", "linear2"):
                sd.update(lin(f"backbone.{i}.{name}", bb[name]["w"][i], bb[name]["b"][i]))
        return sd
    sd["pos_encoder.embedding"] = t(p["pos_encoder"]["embedding"])
    for i in range(np.shape(bb["attn"]["in_proj_w"])[0]):
        pre = f"backbone.{i}."
        sd[pre + "in_proj_weight"] = t(bb["attn"]["in_proj_w"][i]).T.contiguous()
        sd[pre + "in_proj_bias"] = t(bb["attn"]["in_proj_b"][i])
        sd.update(lin(pre + "out_proj", bb["attn"]["out_w"][i], bb["attn"]["out_b"][i]))
        sd.update(lin(pre + "linear1", bb["linear1"]["w"][i], bb["linear1"]["b"][i]))
        sd.update(lin(pre + "linear2", bb["linear2"]["w"][i], bb["linear2"]["b"][i]))
        for norm, ln in _LAYERNORMS:
            sd[pre + f"{norm}.weight"] = t(bb[ln]["scale"][i])
            sd[pre + f"{norm}.bias"] = t(bb[ln]["bias"][i])
    return sd


def state_dict_to_jax_variables(
    state_dict: Mapping[str, torch.Tensor],
) -> dict[str, dict[str, Any]]:
    """The JAX ``{"params", "constants"}`` tree (numpy float32 leaves,
    layers stacked on a leading axis) of a score network's state dict."""

    def a(key: str) -> np.ndarray:
        return state_dict[key].detach().cpu().float().numpy()

    def lin(prefix: str) -> dict[str, np.ndarray]:
        return {"w": a(f"{prefix}.weight").T.copy(), "b": a(f"{prefix}.bias")}

    num_layers = len({k.split(".")[1] for k in state_dict if k.startswith("backbone.")})
    layers = []
    for i in range(num_layers):
        pre = f"backbone.{i}."
        if pre + "w_ih" in state_dict:
            layers.append({k: (a(pre + k).T.copy() if k.startswith("w") else a(pre + k))
                           for k in _LSTM_KEYS})
        elif pre + "in_proj_weight" not in state_dict:
            layers.append({"linear1": lin(pre + "linear1"), "linear2": lin(pre + "linear2")})
        else:
            layers.append({
                "attn": {
                    "in_proj_w": a(pre + "in_proj_weight").T.copy(),
                    "in_proj_b": a(pre + "in_proj_bias"),
                    "out_w": a(pre + "out_proj.weight").T.copy(),
                    "out_b": a(pre + "out_proj.bias"),
                },
                "linear1": lin(pre + "linear1"),
                "linear2": lin(pre + "linear2"),
                **{ln: {"scale": a(pre + f"{norm}.weight"), "bias": a(pre + f"{norm}.bias")}
                   for norm, ln in _LAYERNORMS},
            })

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(leaf[k] for leaf in leaves)) for k in leaves[0]}
        return np.stack(leaves)

    dense = lin("time_encoder.dense")
    params = {
        "embedder": lin("embedder"),
        "unembedder": lin("unembedder"),
        "time_encoder": {"dense_w": dense["w"], "dense_b": dense["b"]},
        "backbone": stack(*layers),
    }
    if "pos_encoder.embedding" in state_dict:
        params["pos_encoder"] = {"embedding": a("pos_encoder.embedding")}
    return {"params": params, "constants": {"time_encoder": {"W": a("time_encoder.W")}}}


def load_jax_variables(network: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX variables tree into ``network`` in place (strict: every
    key and shape must match) and return it."""
    network.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return network
