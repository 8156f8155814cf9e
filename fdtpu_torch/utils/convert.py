"""Carry weights from the JAX package into the port.

``load_jax_variables(network, variables)`` takes the JAX score model's
``{"params", "constants"}`` tree with numpy (or array-like) leaves — the
encoder layers stacked on a leading L axis, linear weights laid out
``(in, out)`` — and copies it into a :class:`ScoreNetwork`, transposing the
linear weights to torch's ``(out, in)``.  The key map is the port's own; it
mirrors ``fdtpu/utils/torch_replica.py:77-120``.
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


def load_jax_variables(network: ScoreNetwork, variables: Mapping[str, Any]) -> ScoreNetwork:
    """Copy a JAX variables tree into ``network`` in place (strict: every
    key and shape must match) and return it."""
    network.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return network
