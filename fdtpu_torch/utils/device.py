"""Device resolution for the port's entry points.

The port runs on the GPU.  An entry point given no device takes ``cuda`` and
raises when there is none; the CPU is used only when the caller asks for it
(``device="cpu"``, as the tests do).  There is no silent fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fdtpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (+device=cpu to a CLI) to run on the CPU "
            "explicitly."
        )
    return dev


def module_device(module: torch.nn.Module) -> Optional[torch.device]:
    """Device of a module's first parameter (None for a parameterless one)."""
    for p in module.parameters():
        return p.device
    return None
