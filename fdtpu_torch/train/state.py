"""Optimizer for the port: global-norm clipping, AdamW and a warmup-cosine
schedule (port of ``fdtpu/train/state.py:27-66``).

``make_lr_schedule`` writes out optax's ``warmup_cosine_decay_schedule``
from 0 to ``lr_max`` and back to 0.  ``clip_by_global_norm_`` has optax's
semantics: nothing is added to the norm (``torch.nn.utils.clip_grad_norm_``
adds 1e-6), and gradients whose norm is at least ``max_norm`` become
``g / norm * max_norm``.  :class:`ClippedAdamW` then takes optax's AdamW
step and decays every parameter, as ``optax.adamw`` does with no mask.  The
learning rate of update ``k`` (counting from 0) is ``schedule(k)``, as optax
evaluates its schedule at the count of updates before this one, so the
first update moves nothing.

With ``accumulate_grad_batches`` k > 1 the optimizer is ``optax.MultiSteps``
(``fdtpu/train/state.py:52-66``): each micro-step folds its gradients into a
running mean (``acc + (g − acc) / (n + 1)``, optax's Welford form), and every
k-th micro-step clips the mean, takes the AdamW step and advances the
schedule once.  The micro-step count carries on across epochs, as
MultiSteps' does.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

# optax.adamw's defaults, which the JAX package trains with.
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


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
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm_fn: Optional[Callable[[list[torch.Tensor]], torch.Tensor]] = None
                         ) -> torch.Tensor:
    """Scale ``grads`` in place to global norm ``max_norm`` where their norm
    is at least that; return the norm before clipping.  No host sync.
    ``norm_fn`` computes the global norm where ``grads`` are one rank's parts
    (tensor parallelism)."""
    norm = (torch.nn.utils.get_total_norm(grads, norm_type=2.0) if norm_fn is None
            else norm_fn(grads))
    clip = norm >= max_norm
    torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))
    return norm


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm, adamw(schedule))`` on torch
    parameters: :meth:`step` clips the gradients, takes one AdamW step at
    the scheduled rate and advances the schedule.

    The update is optax's, written out in ``_foreach`` operations on
    float32 device tensors, with no host value in it: the rate of update k
    is entry k of a float32 table of ``schedule`` on the parameters' device
    (``schedule`` is constant from entry ``horizon - 1`` on), the update count
    is a device tensor, so a step can be captured into a CUDA graph and
    replayed, and an eager step runs the same arithmetic.

    ``accumulate_grad_batches`` k > 1 (module docstring): :meth:`update`
    folds the gradients into the running mean, and on the micro-step that
    :attr:`emits` also updates from that mean.  The host knows which
    micro-step comes next (:attr:`mini_step`), so a captured step graph is
    keyed on :attr:`emits`; the mean's divisor is a device count.
    ``grad_norm``: the clip's global norm, for parameters that are one
    rank's parts of a tensor-parallel model (:func:`clip_by_global_norm_`)."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        schedule: Callable[[int], float],
        gradient_clip_val: float = 1.0,
        weight_decay: float = 0.01,
        horizon: int = 1,
        accumulate_grad_batches: int = 1,
        grad_norm: Optional[Callable[[list[torch.Tensor]], torch.Tensor]] = None,
    ) -> None:
        self.params = [p for p in params if p.requires_grad]
        self.grad_norm = grad_norm
        self.schedule = schedule
        self.gradient_clip_val = gradient_clip_val
        self.weight_decay = weight_decay
        self.accumulate_grad_batches = max(1, int(accumulate_grad_batches))
        self.count = 0
        self.mini_step = 0
        device = self.params[0].device
        self.rates = torch.tensor([schedule(k) for k in range(max(1, horizon))],
                                  dtype=torch.float32, device=device)
        self.updates = torch.zeros((), dtype=torch.int64, device=device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        if self.accumulate_grad_batches > 1:
            self.acc = [torch.zeros_like(p) for p in self.params]
            self.acc_count = torch.zeros((), dtype=torch.float32, device=device)

    @property
    def lr(self) -> float:
        """The rate of the next update."""
        return self.schedule(self.count)

    @property
    def emits(self) -> bool:
        """Whether the next micro-step ends with an update."""
        return self.mini_step == self.accumulate_grad_batches - 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> None:
        """One micro-step (:meth:`update`) and the host counts
        (:meth:`advance`)."""
        self.update()
        self.advance()

    def advance(self) -> None:
        """The host counts after a micro-step: the micro-step index, and the
        schedule's count where it updated."""
        if self.emits:
            self.count += 1
            self.mini_step = 0
        else:
            self.mini_step += 1

    @torch.no_grad()
    def update(self) -> None:
        """The micro-step on the device alone: what a captured graph replays
        (the caller then calls :meth:`advance`)."""
        grads = [p.grad for p in self.params]
        if self.accumulate_grad_batches > 1:
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, self.acc_count + 1.0)
            torch._foreach_add_(self.acc, delta)
            self.acc_count.add_(1.0)
            if not self.emits:
                return
            grads = self.acc
        clip_by_global_norm_(grads, self.gradient_clip_val, self.grad_norm)
        b1, b2 = ADAM_BETAS
        last = self.rates.shape[0] - 1
        lr = self.rates.index_select(0, torch.clamp(self.updates, max=last).reshape(1))[0]
        self.updates.add_(1)
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        count = self.updates.to(torch.float32)
        mu_hat = torch._foreach_div(self.mu, 1.0 - torch.pow(b1, count))
        nu_hat = torch._foreach_div(self.nu, 1.0 - torch.pow(b2, count))
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, ADAM_EPS)
        update = torch._foreach_div(mu_hat, nu_hat)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(self.params, update)
        if self.accumulate_grad_batches > 1:
            torch._foreach_zero_(self.acc)
            self.acc_count.zero_()

    def state_dict(self) -> dict:
        """The optimizer's state: moments, counts and the accumulated mean."""
        state = {"count": self.count, "mini_step": self.mini_step, "updates": self.updates,
                 "mu": self.mu, "nu": self.nu}
        if self.accumulate_grad_batches > 1:
            state.update(acc=self.acc, acc_count=self.acc_count)
        return state

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` in place (the tensors keep their
        addresses, which captured graphs hold)."""
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        self.updates.copy_(state["updates"])
        names = ["mu", "nu"] + (["acc"] if self.accumulate_grad_batches > 1 else [])
        for name in names:
            for dst, src in zip(getattr(self, name), state[name], strict=True):
                dst.copy_(src)
        if self.accumulate_grad_batches > 1:
            self.acc_count.copy_(state["acc_count"])


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    lr_max: float,
    num_training_steps: int,
    num_warmup_steps: Optional[int] = None,
    gradient_clip_val: float = 1.0,
    weight_decay: float = 0.01,
    accumulate_grad_batches: int = 1,
    grad_norm: Optional[Callable[[list[torch.Tensor]], torch.Tensor]] = None,
) -> ClippedAdamW:
    """AdamW + warmup-cosine + global-norm clipping over ``params``, one
    update every ``accumulate_grad_batches`` micro-steps (``grad_norm`` as in
    :class:`ClippedAdamW`)."""
    schedule = make_lr_schedule(lr_max, num_training_steps, num_warmup_steps)
    # The schedule is constant (0) from step max(2, num_training_steps) on.
    return ClippedAdamW(params, schedule, gradient_clip_val, weight_decay,
                        horizon=max(2, num_training_steps) + 1,
                        accumulate_grad_batches=accumulate_grad_batches, grad_norm=grad_norm)
