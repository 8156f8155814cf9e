"""Plain PyTorch reference of the reverse chain: uncached, and at the
E²-CRF score level (the JAX package's ``score_level_body`` and
``score_skip_decision``, written out as a host loop).

Score level.  Step ``s`` (a count global over the call's trajectories) runs
the network when the cache is cold, on the calibration step right after a
cold refresh (drift rate still 0), when ``R`` steps have passed since the
last refresh, or when the accumulated predicted drift ``err_acc`` reached
τ₀; otherwise it rebuilds the score from ε̂ extrapolated (order
``eps_order``) past the last refresh.  A refresh measures the drift rate:
‖ε̂_new − ε̂_pred‖ / max(‖ε̂_new‖ + 1e-8, 0.1·(high-water ‖ε̂‖)) over the
steps it bridged.  Each later trajectory of a call starts cold with a zero
drift rate and keeps the rest of the state.

Following the judged run.  The budget test ``err_acc ≥ τ₀`` compares a sum
of measured rates with a threshold: two correct float32 programs can fall on
either side of it when ``err_acc`` lies within rounding of τ₀.  Where it
does (``|err_acc − τ₀| ≤ band·τ₀``) the reference takes the judged run's
decision for that step, so that both go on along the same branch; everywhere
else it takes its own, and a judged decision that differs counts as a
mismatch."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from portbench.reference.model import VP


def _predict(eps_hat, eps_prev, gap, ahead, order):
    if order == 0:
        return eps_hat
    if order != 1:
        raise ValueError(f"eps_order {order} has no reference here")
    slope = (eps_hat - eps_prev) / max(gap, 1.0) if gap > 0 else torch.zeros_like(eps_hat)
    return eps_hat + slope * ahead


def run_call(net: Callable, vp: VP, prior: torch.Tensor, noise: torch.Tensor, batch: int,
             cache: Optional[dict], follow: Optional[torch.Tensor] = None,
             band: float = 1e-4) -> dict:
    """One sampling call: ``prior`` ``(N, T, C)`` standard normals,
    ``noise`` ``(steps, N, T, C)``; trajectories of ``batch`` rows in order.
    ``cache``: the score level's ``cache_kwargs`` (None: uncached).
    ``follow``: the judged run's modes ``(N // batch, steps)`` (1 refresh,
    0 skip), taken inside the band.  Returns the samples, the modes taken,
    and the counts of followed and mismatched decisions."""
    steps = noise.shape[0]
    ts, dt = vp.timesteps(steps, prior.device)
    n_traj = prior.shape[0] // batch
    out, modes = [], torch.zeros((n_traj, steps), dtype=torch.int64)
    followed = mismatched = 0
    st = None
    if cache is not None:
        tau = torch.tensor(cache["tau_0"], dtype=torch.float32, device=prior.device)
        r, order = cache["R"], cache.get("eps_order", 1)
        zero = torch.zeros((), device=prior.device)
        st = dict(step=0, last_full=0, eps_hat=None, eps_prev=None, gap=0.0, drift=zero,
                  err=zero, norm_ref=zero)
    for j in range(n_traj):
        rows = slice(j * batch, (j + 1) * batch)
        x = vp.prior(prior[rows])
        if st is not None:
            st["cold"], st["drift"] = True, torch.zeros_like(st["drift"])
        for i in range(steps):
            t = ts[i]
            t_b = t.expand(batch)
            _, std = vp.mean_std(x, t_b)
            if st is None:
                score = net(x, t_b)
            else:
                since = st["step"] - st["last_full"]
                forced = st["cold"] or since >= r or (since == 1 and float(st["drift"]) == 0.0)
                err = float(st["err"])
                refresh = forced or err >= float(tau)
                if not forced and follow is not None:
                    judged = bool(follow[j, i])
                    if abs(err - float(tau)) <= band * float(tau):
                        followed += judged != refresh
                        refresh = judged
                    elif judged != refresh:
                        mismatched += 1
                modes[j, i] = int(refresh)
                if refresh:
                    score = net(x, t_b)
                    eps_new = -std[..., None] * score
                    denom = torch.linalg.vector_norm(eps_new) + 1e-8
                    st["norm_ref"] = torch.maximum(st["norm_ref"], denom)
                    bridged = float(max(since, 1))
                    if st["cold"]:
                        st["drift"] = torch.zeros_like(denom)
                        st["eps_prev"], st["gap"] = eps_new, 0.0
                    else:
                        pred = _predict(st["eps_hat"], st["eps_prev"], st["gap"], bridged, order)
                        rel = torch.linalg.vector_norm(eps_new - pred) / torch.maximum(
                            denom, 0.1 * st["norm_ref"])
                        st["drift"] = rel / bridged
                        st["eps_prev"], st["gap"] = st["eps_hat"], bridged
                    st["eps_hat"], st["err"] = eps_new, torch.zeros_like(denom)
                    st["last_full"], st["cold"] = st["step"], False
                else:
                    eps = _predict(st["eps_hat"], st["eps_prev"], st["gap"], float(since + 1),
                                   order)
                    score = -eps / std[..., None]
                    st["err"] = st["err"] + st["drift"]
                st["step"] += 1
            x = vp.step(score, t, x, noise[i, rows], dt)
        out.append(x)
    return dict(samples=torch.cat(out), modes=modes, followed=followed, mismatched=mismatched)
