"""Faults planted under the timed path, to show that the check catches them
(``tests/test_faults.py`` on the CPU, ``control.py --fault`` on the card):

* ``state_unchanged``: a step that returns its state unchanged (the
  sampler's Euler–Maruyama update returns ``x``; the optimiser's update
  moves nothing);
* ``half_batch``: half of the batch left out (the network's score of the
  second half of the rows is zero; the training loss is the mean over the
  first half of the rows);
* ``answer_altered``: an answer altered where it is produced (one value of
  each sample moves by 1e-2 of the call's largest value; each training
  loss is scaled by 1 + 1e-2)."""

from __future__ import annotations

import contextlib
from typing import Optional
from unittest import mock

import torch


def _state_unchanged():
    from fdtpu_torch.diffusion.sde import VPScheduler
    from fdtpu_torch.train.state import ClippedAdamW

    return [mock.patch.object(VPScheduler, "step", lambda self, out, t, x, z, dt: x),
            mock.patch.object(ClippedAdamW, "update", lambda self: None)]


def _half_batch():
    from fdtpu_torch.models.score_models import ScoreNetwork
    from fdtpu_torch.train import trainer

    forward, loss = ScoreNetwork.forward, trainer.sde_loss

    def half_forward(self, x, timesteps, train=False, generator=None):
        out = forward(self, x, timesteps, train, generator)
        if train:
            return out
        half = x.shape[0] // 2
        return torch.cat([out[:half], torch.zeros_like(out[half:])])

    def half_loss(network, scheduler, x, *args, **kwargs):
        return loss(network, scheduler, x[: max(1, x.shape[0] // 2)], *args, **kwargs)

    return [mock.patch.object(ScoreNetwork, "forward", half_forward),
            mock.patch.object(trainer, "sde_loss", half_loss)]


def _answer_altered():
    from fdtpu_torch.sampling.sampler import DiffusionSampler
    from fdtpu_torch.train import trainer

    sample, loss = DiffusionSampler.sample, trainer.sde_loss

    def altered_sample(self, *args, **kwargs):
        x = sample(self, *args, **kwargs)
        x = x.clone()
        x[:, 0, 0] += 1e-2 * x.abs().max()
        return x

    def altered_loss(*args, **kwargs):
        return loss(*args, **kwargs) * (1.0 + 1e-2)

    return [mock.patch.object(DiffusionSampler, "sample", altered_sample),
            mock.patch.object(trainer, "sde_loss", altered_loss)]


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@contextlib.contextmanager
def planted(name: Optional[str]):
    """Run the block with fault ``name`` planted (None: none)."""
    with contextlib.ExitStack() as stack:
        if name is not None:
            for patch in FAULTS[name]():
                stack.enter_context(patch)
        yield
