"""Optimizer for the port: global-norm clipping, AdamW and a warmup-cosine
schedule (port of ``fdtpu/train/state.py:27-66``).

``make_lr_schedule`` writes out optax's ``warmup_cosine_decay_schedule``
from 0 to ``lr_max`` and back to 0.  ``clip_by_global_norm_`` has optax's
semantics: nothing is added to the norm (``torch.nn.utils.clip_grad_norm_``
adds 1e-6), and gradients whose norm is at least ``max_norm`` become
``g / norm * max_norm``.  ``torch.optim.AdamW`` then decays every parameter,
as ``optax.adamw`` does with no mask.  The learning rate of update ``k``
(counting from 0) is ``schedule(k)``, as optax evaluates its schedule at the
count of updates before this one, so the first update moves nothing.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch


def make_lr_schedule(
    lr_max: float,
    num_training_steps: int,
    num_warmup_steps: Optional[int] = None,
) -> Callable[[int], float]:
    """Linear warmup from 0 over ``max(1, warmup)`` steps (default
    ``num_training_steps // 10``), then cosine decay to 0 at step
    ``max(2, num_training_steps)``, constant 0 after."""
    if num_warmup_steps is None:
        num_warmup_steps = num_training_steps // 10
    warmup = max(1, num_warmup_steps)
    decay = max(2, num_training_steps) - warmup
    if decay <= 0:
        raise ValueError(
            f"cosine decay needs num_training_steps > warmup, got "
            f"{num_training_steps} and {warmup}"
        )

    def schedule(step: int) -> float:
        if step < warmup:
            frac = 1.0 - min(max(step, 0), warmup) / warmup
            return -lr_max * frac + lr_max
        count = min(step - warmup, decay)
        return lr_max * 0.5 * (1.0 + math.cos(math.pi * count / decay))

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to global norm ``max_norm`` where their norm
    is at least that; return the norm before clipping.  No host sync."""
    norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
    clip = norm >= max_norm
    torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))
    return norm


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm, adamw(schedule))`` on torch
    parameters: :meth:`step` clips the gradients, takes one AdamW step at
    the scheduled rate and advances the schedule."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        schedule: Callable[[int], float],
        gradient_clip_val: float = 1.0,
        weight_decay: float = 0.01,
    ) -> None:
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.gradient_clip_val = gradient_clip_val
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )

    @property
    def lr(self) -> float:
        """The rate of the next update."""
        return self.schedule(self.count)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        clip_by_global_norm_(grads, self.gradient_clip_val)
        self.adamw.step()
        self.count += 1
        for group in self.adamw.param_groups:
            group["lr"] = self.lr


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    lr_max: float,
    num_training_steps: int,
    num_warmup_steps: Optional[int] = None,
    gradient_clip_val: float = 1.0,
    weight_decay: float = 0.01,
) -> ClippedAdamW:
    """AdamW + warmup-cosine + global-norm clipping over ``params``."""
    schedule = make_lr_schedule(lr_max, num_training_steps, num_warmup_steps)
    return ClippedAdamW(params, schedule, gradient_clip_val, weight_decay)
