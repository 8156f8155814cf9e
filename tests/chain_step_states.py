"""States of the score level's reverse step, loaded into a resident chain's
static tensors: the boundaries of the decision first, then random states.
The card tests hold the chain's step kernels to its PyTorch segments over
them (``tests/test_torch_cuda.py``); ``tests/test_torch_chain_step.py``
checks on the CPU that the segments reach each decision from them."""

import numpy as np
import torch

from fdtpu_torch.cache.e2crf import COUNTERS
from fdtpu_torch.sampling import resident

SCALARS = ("drift_rate", "err_acc", "overrun", "eps_gap", "eps_gap2")


def states(R: int, tau: float, n: int = 10) -> list[dict]:
    """A cold cache at step 0, the calibration step (since 1, drift rate 0),
    since 1 with a drift rate, R expired, since R − 1, ``err_acc`` at the
    float32 ``tau`` and at ``tau`` / overrun, the ε̂ gaps 0; then ``n``
    random states.  ``i`` is the step index, below 12."""
    rng = np.random.default_rng(5)
    fixed = [dict(cold=1, step=0, last_full_step=0),
             dict(step=5, last_full_step=4, drift_rate=0.0),
             dict(step=5, last_full_step=4, drift_rate=0.1),
             dict(step=24, last_full_step=24 - R), dict(step=23, last_full_step=24 - R),
             dict(err_acc=tau, overrun=2.0), dict(err_acc=tau / 2, overrun=2.0),
             dict(eps_gap=0.0, eps_gap2=0.0), dict(eps_gap=3.0, eps_gap2=0.0),
             dict(eps_gap=0.0, eps_gap2=2.0)]
    out = []
    for i in range(len(fixed) + n):
        step = int(rng.integers(1, 600))
        f = dict(step=step, last_full_step=step - int(rng.integers(1, 2 * R)), cold=0,
                 drift_rate=float(rng.choice([0.0, rng.uniform(0, 0.2)])),
                 err_acc=float(rng.uniform(0, 0.6)), overrun=float(rng.uniform(0.5, 3.0)),
                 eps_gap=float(rng.choice([0, 1, 2, 5, 17])),
                 eps_gap2=float(rng.choice([0, 1, 3, 9])),
                 recompute_count=int(rng.integers(0, 10_000)),
                 cache_hit_count=int(rng.integers(0, 10_000)), full_steps=int(rng.integers(0, 99)),
                 mixed_steps=0, cached_steps=int(rng.integers(0, 999)), i=int(rng.integers(12)))
        if i < len(fixed):
            f.update(fixed[i])
        f["last_full_step"] = max(0, min(f["last_full_step"], f["step"]))
        out.append(f)
    return out


def load(chain, fields: dict, seed: int) -> None:
    """The state ``fields`` into the chain's static tensors, with a random ε̂
    history, x, score and noise from ``seed``, and the branches' runs 3, 1, 2."""
    rng = np.random.default_rng(seed)

    def randn(t: torch.Tensor) -> None:
        t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)))

    for name in ("eps_hat", "eps_prev", "eps_prev2"):
        randn(chain.tensors[name])
    for name in SCALARS:
        chain.tensors[name].fill_(fields[name])
    chain.clock.zero_()
    chain.clock[0] = fields["i"]
    chain.clock[1:resident.RUNS] = torch.tensor([fields[k] for k in COUNTERS])
    chain.clock[resident.RUNS:] = torch.tensor([3, 1, 2])
    for t in (chain.x, chain.score, chain.noise):
        randn(t)
    chain.mode.fill_(-1)
    chain.modes.fill_(-1)
