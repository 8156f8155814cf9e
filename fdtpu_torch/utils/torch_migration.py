"""Migration from the reference PyTorch checkpoints (port of
``fdtpu/utils/torch_migration.py``).

Maps a reference FourierDiffusion ``ScoreModule`` Lightning state dict
straight onto the port's transformer :class:`~fdtpu_torch.models.
score_models.ScoreNetwork` state dict (both hold torch's ``(out, in)``
linear weights, so nothing is transposed):

    embedder.{weight,bias}                      → embedder.{weight,bias}
    pos_encoder.embedding.weight                → pos_encoder.embedding
    time_encoder.W                              → time_encoder.W
    time_encoder.dense.{weight,bias}            → time_encoder.dense.{weight,bias}
    backbone.layers.{i}.self_attn.in_proj_*     → backbone.{i}.in_proj_*
    backbone.layers.{i}.self_attn.out_proj.*    → backbone.{i}.out_proj.*
    backbone.layers.{i}.linear{1,2}.*           → backbone.{i}.linear{1,2}.*
    backbone.layers.{i}.norm{1,2}.*             → backbone.{i}.norm{1,2}.*
    unembedder.{weight,bias}                    → unembedder.{weight,bias}

Load the result with ``init_score_model(cfg, device=...).load_state_dict(
state_dict)``.
"""

from __future__ import annotations

import io
import pickle
from pathlib import Path
from typing import Any, Mapping

import torch

from fdtpu_torch.models.score_models import ScoreModelConfig

_LAYER_KEYS = {
    "self_attn.in_proj_weight": "in_proj_weight",
    "self_attn.in_proj_bias": "in_proj_bias",
    "self_attn.out_proj.weight": "out_proj.weight",
    "self_attn.out_proj.bias": "out_proj.bias",
    **{f"{m}.{p}": f"{m}.{p}" for m in ("linear1", "linear2", "norm1", "norm2")
       for p in ("weight", "bias")},
}
_TOP_KEYS = {
    **{f"{m}.{p}": f"{m}.{p}" for m in ("embedder", "unembedder", "time_encoder.dense")
       for p in ("weight", "bias")},
    "pos_encoder.embedding.weight": "pos_encoder.embedding",
    "time_encoder.W": "time_encoder.W",
}


def convert_reference_state_dict(
    state_dict: Mapping[str, Any], cfg: ScoreModelConfig
) -> dict[str, torch.Tensor]:
    """A reference transformer ``ScoreModule`` state dict → the port's
    ``ScoreNetwork`` state dict (float32 CPU tensors)."""
    if cfg.backbone != "transformer":
        raise ValueError("conversion is implemented for the transformer backbone, "
                         f"not {cfg.backbone!r}")

    def t(x) -> torch.Tensor:
        return torch.as_tensor(x).detach().to("cpu", torch.float32).clone()

    sd = {new: t(state_dict[old]) for old, new in _TOP_KEYS.items()}
    for i in range(cfg.num_layers):
        sd.update({f"backbone.{i}.{new}": t(state_dict[f"backbone.layers.{i}.{old}"])
                   for old, new in _LAYER_KEYS.items()})
    return sd


class _Tolerant(pickle.Unpickler):
    """Stands a placeholder class in for one that cannot be imported (the
    reference pickles its scheduler and Lightning objects into a ``.ckpt``)."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (), {})


def load_reference_checkpoint(
    ckpt_path: Path | str, cfg: ScoreModelConfig
) -> dict[str, torch.Tensor]:
    """Load a reference Lightning ``.ckpt`` and convert its weights; a
    pickled object whose class is not importable here is read as a
    placeholder (the checkpoint is trusted: it is unpickled)."""
    try:
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    except (ImportError, AttributeError, pickle.UnpicklingError):
        data = Path(ckpt_path).read_bytes()
        ckpt = torch.load(io.BytesIO(data), map_location="cpu", weights_only=False,
                          pickle_module=type("M", (), {"Unpickler": _Tolerant,
                                                       "load": pickle.load}))
    return convert_reference_state_dict(ckpt.get("state_dict", ckpt), cfg)
