"""Plain PyTorch reference of the reverse chain at the E²-CRF token level (the
JAX package's ``token_level_body`` and ``token_policy``, written out as a
host loop over the FourierDiffusion transformer of ``reference/model.py``).

The network keeps a K/V store, each layer's keys and values of every token
(B, T, H, Dh).  A FULL step runs the whole network and stores every token's
K/V; a TOPK step runs only the ``token_budget`` chosen rows through the
network: their K/V go into the store and their queries attend to all T
stored keys; a SKIP step runs no network.

The policy, at each step: FULL on a cold cache, when ``R`` steps have passed
since the last FULL, or on the calibration step right after a FULL whose
per-token rates are all 0; else SKIP while the predicted error
``mean(w_drift · (age + 1))`` stays within τ₀, else TOPK.  ``w_drift`` is
each token's drift rate weighted by its energy share (the mean over batch
and channels of x²).  A TOPK step takes the rows of the ``budget`` highest
priorities ``w_drift · (age + 1)`` (plus 2e9 for the ``K`` lowest
frequencies and 1e9 for the random probes, the step's uniforms below the
probe ratio), lower index first among ties.  Between refreshes each token's
ε̂ is extrapolated linearly from its last two recomputes; a recompute
measures the token's residual rate against that extrapolation.  Each later
trajectory of a call starts cold and keeps the rest of the state.

Following the judged run.  Two correct float32 programs can take other
branches where a comparison falls within rounding: the budget test (the
predicted error within ``band``·τ₀ of τ₀), and the choice of rows (a row's
priority within ``band`` of the priority at the budget's edge).  There the
reference takes the judged run's mode, or its rows, so that both go on
along the same branch; everywhere else it takes its own, and counts a judged
mode that differs as a mismatched decision and each judged row outside its
own rows as a mismatched row."""

from __future__ import annotations

import math
from typing import Optional

import torch

from portbench.reference.model import VP, _layer_norm

FULL, TOPK, SKIP = 0, 1, 2


class Network:
    """The transformer of ``reference/model.py`` (no dropout) with a K/V
    store.  ``full`` runs every token and fills the store; ``rows`` runs
    tokens ``idx`` only."""

    def __init__(self, weights: dict, model: dict, batch: int, device) -> None:
        self.w, self.m = weights, model
        d, h = model["d_model"], model["n_head"]
        shape = (model["num_layers"], batch, model["max_len"], h, d // h)
        self.k = torch.zeros(shape, device=device)
        self.v = torch.zeros(shape, device=device)

    def _embed(self, x, t, positions):
        w, d = self.w, self.m["d_model"]
        h = x @ w["embedder.weight"].T + w["embedder.bias"]
        table = w["pos_encoder.embedding"]
        norms = torch.sqrt((table * table).sum(dim=-1, keepdim=True))
        table = table * torch.clamp(math.sqrt(d) / (norms + 1e-7), max=1.0)
        h = h + table[positions][None]
        phase = t[:, None] * w["time_encoder.W"][None, :] * 2.0 * math.pi
        emb = torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1)[:, :d]
        return h + (emb @ w["time_encoder.dense.weight"].T + w["time_encoder.dense.bias"])[:, None]

    def _layers(self, h, rows):
        """Every layer over the hidden states ``h`` of tokens ``rows`` (a
        slice or an index tensor): their K/V into the store, their queries
        against all stored keys."""
        w, m = self.w, self.m
        d, h_n = m["d_model"], m["n_head"]
        dh = d // h_n
        b, n, _ = h.shape
        for i in range(m["num_layers"]):
            p = f"backbone.{i}."
            qkv = h @ w[p + "in_proj_weight"].T + w[p + "in_proj_bias"]
            q, k, v = (a.reshape(b, n, h_n, dh) for a in qkv.split(d, dim=-1))
            self.k[i][:, rows] = k
            self.v[i][:, rows] = v
            s = torch.einsum("bqhd,bkhd->bhqk", q, self.k[i]) / math.sqrt(dh)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), self.v[i])
            o = o.reshape(b, n, d) @ w[p + "out_proj.weight"].T + w[p + "out_proj.bias"]
            h = _layer_norm(h + o, w[p + "norm1.weight"], w[p + "norm1.bias"], m["ln_eps"])
            ff = torch.relu(h @ w[p + "linear1.weight"].T + w[p + "linear1.bias"])
            ff = ff @ w[p + "linear2.weight"].T + w[p + "linear2.bias"]
            h = _layer_norm(h + ff, w[p + "norm2.weight"], w[p + "norm2.bias"], m["ln_eps"])
        return h @ w["unembedder.weight"].T + w["unembedder.bias"]

    def full(self, x, t):
        everything = torch.arange(x.shape[1], device=x.device)
        return self._layers(self._embed(x, t, everything), slice(None))

    def rows(self, x, t, idx):
        return self._layers(self._embed(x[:, idx], t, idx), idx)


def _tok_norms(eps):
    return torch.linalg.vector_norm(eps, dim=(0, 2))


def _residual_rate(eps_new, pred, ages, ref):
    num = _tok_norms(eps_new - pred)
    rel = num / torch.maximum(_tok_norms(eps_new) + 1e-8, 0.1 * ref)
    return rel / torch.clamp(ages, min=1.0)


def _order(priority: list) -> list:
    """Token indices by priority, highest first, lower index first among ties."""
    return sorted(range(len(priority)), key=lambda j: (-priority[j], j))


def run_call(weights: dict, model: dict, vp: VP, prior, noise, probes, batch: int,
             cache: dict, follow_modes: Optional[torch.Tensor] = None,
             follow_rows: Optional[torch.Tensor] = None, band: float = 1e-4) -> dict:
    """One sampling call of the network of ``weights`` (``reference/model.py``'s
    names) and ``model``: ``prior`` ``(N, T, C)`` and ``noise`` ``(steps, N,
    T, C)`` standard normals, ``probes`` ``(N // batch, steps, T)`` the
    steps' probe uniforms; trajectories of ``batch`` rows in order.
    ``cache``: the token level's ``cache_kwargs``.  ``follow_modes``
    ``(N // batch, steps)`` and ``follow_rows`` ``(N // batch, steps,
    budget)``: the judged run's modes and TOPK rows, taken inside the band.
    Returns the samples, the modes and rows taken (−1 at the steps that took
    no TOPK), and the counts of followed and mismatched decisions and rows."""
    steps, device = noise.shape[0], prior.device
    t_len = prior.shape[1]
    ts, dt = vp.timesteps(steps, device)
    n_traj = prior.shape[0] // batch
    net = Network(weights, model, batch, device)
    tau = float(torch.tensor(cache["tau_0"], dtype=torch.float32))
    r_max, n_low = cache.get("R", 10), cache.get("K", 5)
    budget = min(int(cache["token_budget"]), t_len)
    ratio = cache.get("random_probe_ratio", -1.0)
    ratio = torch.tensor(0.02 if ratio < 0 else ratio, dtype=torch.float32)
    low_bonus = torch.where(torch.arange(t_len, device=device) < n_low, 2e9, 0.0)
    zeros_t = torch.zeros((t_len,), device=device)
    st = dict(step=0, last_full=0, last_tok=torch.zeros((t_len,), dtype=torch.int64,
                                                        device=device),
              gap=zeros_t.clone(), delta=zeros_t.clone(), norm_ref=zeros_t.clone(),
              eps_hat=torch.zeros((batch, t_len, prior.shape[2]), device=device))
    st["eps_prev"] = torch.zeros_like(st["eps_hat"])
    out, modes = [], torch.zeros((n_traj, steps), dtype=torch.int64)
    taken = torch.full((n_traj, steps, budget), -1, dtype=torch.int64)
    counts = dict(followed=0, mismatched=0, rows_followed=0, rows_mismatched=0)
    for j in range(n_traj):
        rows = slice(j * batch, (j + 1) * batch)
        x = vp.prior(prior[rows])
        cold = True
        for i in range(steps):
            t = ts[i]
            t_b = t.expand(batch)
            _, std = vp.mean_std(x, t_b)
            step = st["step"]
            energy = (x * x).mean(dim=(0, 2))
            w_drift = st["delta"] * (energy / (energy.mean() + 1e-8))
            age = (step - st["last_tok"]).float()
            predicted = float((w_drift * (age + 1.0)).mean())
            since = step - st["last_full"]
            forced = cold or since >= r_max or (since == 1 and float(st["delta"].sum()) == 0.0)
            mode = FULL if forced else (SKIP if predicted <= tau else TOPK)
            if follow_modes is not None:
                judged = int(follow_modes[j, i])
                if not forced and judged != FULL and abs(predicted - tau) <= band * tau:
                    counts["followed"] += judged != mode
                    mode = judged
                elif judged != mode:
                    counts["mismatched"] += 1
            modes[j, i] = mode
            gap = st["gap"][None, :, None]
            slope = torch.where(gap > 0, (st["eps_hat"] - st["eps_prev"])
                                / torch.clamp(gap, min=1.0), 0.0)
            eps_pred = st["eps_hat"] + slope * age[None, :, None]
            if mode == FULL:
                eps_new = -std[..., None] * net.full(x, t_b)
                norm_ref = torch.maximum(st["norm_ref"], _tok_norms(eps_new))
                rate = (zeros_t if cold else
                        _residual_rate(eps_new, eps_pred, age, norm_ref))
                st.update(eps_prev=eps_new if cold else st["eps_hat"],
                          gap=zeros_t if cold else age, eps_hat=eps_new, delta=rate,
                          norm_ref=norm_ref, last_full=step,
                          last_tok=torch.full_like(st["last_tok"], step))
                cold = False
                score = -eps_new / std[..., None]
            elif mode == TOPK:
                probe = torch.where(probes[j, i] < ratio, 1e9, 0.0)
                priority = (w_drift * (age + 1.0) + low_bonus + probe).tolist()
                own = _order(priority)[:budget]
                idx = torch.tensor(own, dtype=torch.int64, device=device)
                if follow_rows is not None:
                    judged = follow_rows[j, i].tolist()
                    extra = set(judged) ^ set(own)
                    edge = priority[own[-1]]
                    if extra and all(abs(priority[r] - edge) <= band * abs(edge) for r in extra):
                        counts["rows_followed"] += 1
                        idx = torch.tensor(judged, dtype=torch.int64, device=device)
                    elif extra:
                        counts["rows_mismatched"] += len(set(judged) - set(own))
                taken[j, i] = idx.cpu()
                eps_rows = -std[:, idx, None] * net.rows(x, t_b, idx)
                age_rows = age[idx]
                ref_rows = torch.maximum(st["norm_ref"][idx], _tok_norms(eps_rows))
                rate_rows = _residual_rate(eps_rows, eps_pred[:, idx], age_rows, ref_rows)
                eps = eps_pred.clone()
                eps[:, idx] = eps_rows
                score = -eps / std[..., None]
                for key, value in (("eps_prev", st["eps_hat"][:, idx]), ("eps_hat", eps_rows)):
                    st[key] = st[key].clone()
                    st[key][:, idx] = value
                for key, value in (("gap", age_rows), ("delta", rate_rows),
                                   ("norm_ref", ref_rows), ("last_tok", step)):
                    st[key] = st[key].clone()
                    st[key][idx] = value
            else:
                score = -eps_pred / std[..., None]
            st["step"] += 1
            x = vp.step(score, t, x, noise[i, rows], dt)
        out.append(x)
    return dict(samples=torch.cat(out), modes=modes, rows=taken, **counts)
