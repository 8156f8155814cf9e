"""Plain PyTorch reference of FourierDiffusion's training (``losses.py``,
``score_models.py``'s optimiser, ``conf/trainer/default.yaml``): the data
prepared from the raw series, the denoising score-matching loss of the VP
SDE, global-norm clipping and AdamW (optax's, as the JAX package trains) on
a warmup-cosine schedule, in float32 with TF32 off.

Data: the kept features of each series, its packed orthonormal real DFT
along time (the real parts of bins 0..⌊T/2⌋, then the imaginary parts of
bins 1.. up to but excluding Nyquist), standardised with the train split's
per-(time, feature) mean and sample std (ddof 1; a std that is 0 or not
finite is 1).  An epoch's batches follow ``numpy.random.default_rng(loader
seed)``'s permutation of the train rows, the last one partial.

A step draws from one generator, seeded with the trainer's seed: t =
u·(1 − eps) + eps with u ~ U(0, 1) (B,), then z ~ N(0, I), then the
network's dropout masks.  The loss is mean over the batch of λ(t)·mean
over (T, C) of (score + z/std)², λ(t) = 1 / Σ_T 1/std².  Clipping: the
gradients' global norm n, g·clip/n where n ≥ clip.  AdamW: β (0.9, 0.999),
eps 1e-8 outside the square root, weight decay 0.01 on every parameter,
the rate of update k the schedule at k: linear from 0 over ⌊steps/10⌋
updates (at least 1), then cosine to 0 at ``steps``.  After the epoch the
val loss: each val batch's loss (t and z drawn, no dropout), averaged with
the batches' sizes as weights."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.model import VP, score

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 0.01


def packed_dft(x: np.ndarray) -> np.ndarray:
    """Orthonormal real DFT along axis 1, packed into the same length."""
    t = x.shape[1]
    f = np.fft.rfft(x.astype(np.float64), axis=1, norm="ortho")
    n_im = t - (t // 2 + 1)
    return np.concatenate([f.real, f.imag[:, 1:1 + n_im]], axis=1)


def prepare(x_train: np.ndarray, x_val: np.ndarray, keep: list[int], fourier: bool,
            standardize: bool) -> tuple[np.ndarray, np.ndarray]:
    xt, xv = x_train[:, :, keep], x_val[:, :, keep]
    if fourier:
        xt, xv = packed_dft(xt), packed_dft(xv)
    xt, xv = xt.astype(np.float64), xv.astype(np.float64)
    if standardize:
        mean = xt.mean(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            std = xt.std(axis=0, ddof=1)
        std = np.where(np.isfinite(std) & (std > 0), std, 1.0)
        xt, xv = (xt - mean) / std, (xv - mean) / std
    return xt.astype(np.float32), xv.astype(np.float32)


def schedule(lr_max: float, total: int):
    warmup = max(1, total // 10)
    decay = max(2, total) - warmup

    def rate(k: int) -> float:
        if k < warmup:
            return lr_max * k / warmup
        return lr_max * 0.5 * (1.0 + math.cos(math.pi * min(k - warmup, decay) / decay))

    return rate


def loss_of(weights, model, vp: VP, xb, generator, train: bool):
    b = xb.shape[0]
    u = torch.rand((b,), generator=generator, device=xb.device)
    t = u * (1.0 - vp.eps) + vp.eps
    z = torch.randn(xb.shape, generator=generator, device=xb.device)
    mean, std = vp.mean_std(xb, t)
    s = score(weights, model, mean + std[..., None] * z, t, generator if train else None)
    lam = 1.0 / torch.sum(1.0 / std**2, dim=1)
    per_row = (lam[:, None, None] * (s + z / std[..., None]) ** 2).reshape(b, -1).mean(dim=-1)
    return per_row.mean()


def first_epoch(weights0: dict, trainable: list[str], model: dict, sde: dict,
                x_train: np.ndarray, x_val: np.ndarray, batch: int, epochs: int,
                lr_max: float, clip: float, trainer_seed: int, loader_seed: int,
                device) -> dict:
    """Epoch 0 of a fit of ``epochs`` epochs from ``weights0``, on prepared
    data.  Returns each step's loss, the val loss, the parameters and
    AdamW's first moments after the epoch, and the first step's gradient
    norm of each leaf (as the optimiser gets it, after clipping)."""
    vp = VP(sde, model["max_len"], device)
    steps = -(-len(x_train) // batch)
    rate = schedule(lr_max, steps * epochs)
    w = {k: v.detach().clone().float().to(device) for k, v in weights0.items()}
    for k in trainable:
        w[k].requires_grad_(True)
    params = [w[k] for k in trainable]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    gen = torch.Generator(device=device).manual_seed(trainer_seed)
    perm = np.random.default_rng(loader_seed).permutation(len(x_train))
    losses, grad1 = [], None
    for k in range(steps):
        xb = torch.from_numpy(x_train[perm[k * batch:(k + 1) * batch]]).to(device)
        loss = loss_of(w, model, vp, xb, gen, train=True)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)).float()
            if norm >= clip:
                grads = [g / norm * clip for g in grads]
            if grad1 is None:
                grad1 = {n: float(torch.linalg.vector_norm(g)) for n, g in zip(trainable, grads)}
            lr = float(np.float32(rate(k)))
            c1, c2 = 1.0 - BETAS[0] ** (k + 1), 1.0 - BETAS[1] ** (k + 1)
            for p, m, v, g in zip(params, mu, nu, grads):
                m.mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                v.mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                upd = (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS) + WEIGHT_DECAY * p
                p.sub_(lr * upd)
    val, sizes = [], []
    with torch.no_grad():
        for s in range(0, len(x_val), batch):
            xb = torch.from_numpy(x_val[s:s + batch]).to(device)
            val.append(float(loss_of(w, model, vp, xb, gen, train=False)))
            sizes.append(len(xb))
    return dict(losses=losses, val_loss=float(np.average(val, weights=sizes)),
                params={k: w[k].detach() for k in trainable},
                mu=dict(zip(trainable, mu)), grad1=grad1)
