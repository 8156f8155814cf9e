"""Training cells: one ``Trainer.fit`` as the window.

Set-up writes the data set the configuration states, made from the seed, as
the prepared files ``USDroughtsDatamodule`` reads (``X_train.npy``,
``X_test.npy`` under a data directory in ``TMPDIR``), makes the weights,
and runs a warm-up fit of two epochs, which builds the kernels and times a
steady epoch.  The window is one fit from the same weights whose
``max_epochs`` makes it last at least ``--seconds``; its wall, from the call
to its return, includes the step graphs' capture, every epoch's validation
and the checkpoint and resume-state writes.  The fit logs every step's loss
of its first epoch; a callback at that epoch's end keeps a copy of the
resume snapshot the fit has written and sets the trainer's
``log_every_n_steps`` to the published 50 for the rest of the fit, so every
later epoch runs as ``configs/trainer/default.yaml`` states.

The check: the plain reference (``reference/train.py``) trains the first
epoch from the same weights on the same rows in the same order with the
same draws, and the fit's first epoch is held to it: each step's loss, the
val loss, and per parameter the norm of its change and of AdamW's first
moment after the epoch.  ``Trainer.fit`` shows its state only at an epoch's
end, so the first epoch is the shortest span the check can follow."""

from __future__ import annotations

import gc
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench.common import stamp, sub_seed
from portbench.program import score_model
from portbench.reference import train as ref_train
from portbench.reference.model import precision
from portbench.trace import WINDOW as tr_window
from portbench.trace import activities as tr_activities
from portbench.trace import phase
from portbench.weights import make_weights


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_series(data: dict, seed: int, device) -> np.ndarray:
    """``(num_series, days, raw_features)`` float32: per series and feature
    a level, a yearly cycle of random amplitude and phase, and day-to-day
    noise, drawn on the device from ``seed``."""
    n, d, f = data["num_series"], data["days"], data["raw_features"]
    g = torch.Generator(device=device).manual_seed(seed)
    level = torch.randn((n, 1, f), generator=g, device=device) * 3.0
    amp = 0.5 + 1.5 * torch.rand((n, 1, f), generator=g, device=device)
    shift = 2.0 * math.pi * torch.rand((n, 1, f), generator=g, device=device)
    day = torch.arange(d, device=device, dtype=torch.float32)[None, :, None] / d
    noise = 0.3 * torch.randn((n, d, f), generator=g, device=device)
    return (level + amp * torch.sin(2.0 * math.pi * day + shift) + noise).cpu().numpy()


class KeepFirstEpoch:
    """A trainer callback: after epoch 0, copy the resume snapshot the fit
    has just written, and log from then on every ``log_every`` steps."""

    def __init__(self, dest: Path, log_every: int) -> None:
        self.dest, self.log_every = dest, log_every

    def on_train_epoch_end(self, trainer, network, epoch) -> None:
        if epoch == 0:
            from fdtpu_torch.train.checkpoint import STATE_FILE

            shutil.copyfile(Path(trainer.run_dir) / "resume" / STATE_FILE, self.dest)
            trainer.log_every_n_steps = self.log_every


class Cell:
    def __init__(self, cell: dict, traffic: dict, config: dict, seed: int, device) -> None:
        self.cell, self.traffic, self.config = cell, traffic, config
        self.seed, self.device = seed, torch.device(device)
        self.model, self.data = config["model"], config["data"]
        self.batch = self.data["batch_size"]
        self.trainer_seed = sub_seed(seed, "trainer")
        self.loader_seed = sub_seed(seed, "loader")

    # ----------------------------------------------------------- program
    def setup(self) -> None:
        from fdtpu_torch.data import USDroughtsDatamodule

        self.tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
        d = self.data
        x = make_series(d, sub_seed(self.seed, "data"), self.device)
        n_train = int(d["train_frac"] * d["num_series"])
        self.x_train, self.x_val = x[:n_train], x[n_train:]
        files = self.tmp / "data" / "droughts"
        files.mkdir(parents=True)
        np.save(files / "X_train.npy", self.x_train)
        np.save(files / "X_test.npy", self.x_val)
        self.dm = USDroughtsDatamodule(data_dir=self.tmp / "data", random_seed=self.loader_seed,
                                       batch_size=self.batch,
                                       fourier_transform=self.config["fourier_transform"],
                                       standardize=self.config["standardize"])
        self.dm.setup()
        stamp("data written and read")
        self.n_train = len(self.dm.X_train)
        self.steps_per_epoch = -(-self.n_train // self.batch)
        self.weights = make_weights(self.model, sub_seed(self.config["weights_seed"], "weights"),
                                    self.device)
        # The optimiser's leaves, in its order: the network's parameters.
        self.names = [n for n, _ in score_model(self.config, self.weights, self.device, 1)
                      .network.named_parameters()]
        warm = self.fit(self.traffic["warm_epochs"], "warm")
        stamp("warm-up fit")
        epoch_s = [r["epoch_time_s"] for r in warm if "epoch_time_s" in r][-1]
        self.epochs = self.traffic["warm_epochs"]
        self.epoch_s = max(epoch_s, 1e-3)

    def fit(self, epochs: int, run_id: str, callbacks=(), log_every=None) -> list[dict]:
        """One ``Trainer.fit`` of ``epochs`` from the benchmark's weights,
        logging every ``log_every`` steps (the published cadence by
        default); returns its log records."""
        from fdtpu_torch.train import Trainer

        t = self.traffic["trainer"]
        log_every = t["log_every_n_steps"] if log_every is None else log_every
        model = score_model(self.config, self.weights, self.device,
                            self.steps_per_epoch * epochs, self.data["lr_max"])
        trainer = Trainer(max_epochs=epochs, gradient_clip_val=self.data["gradient_clip_val"],
                          run_dir=self.tmp / "runs", run_id=run_id, seed=self.trainer_seed,
                          steps_per_call=t["steps_per_call"], epochs_per_call=t["epochs_per_call"],
                          log_every_n_steps=log_every, callbacks=list(callbacks))
        with phase("fit"):
            trainer.fit(model, self.dm)
            _sync(self.device)
        with open(trainer.metrics_path) as f:
            return [json.loads(line) for line in f]

    def window(self, seconds: float) -> dict:
        self.epochs = max(1, math.ceil(seconds / self.epoch_s))
        self.snapshot = self.tmp / "epoch0.pt"
        _sync(self.device)
        t0 = time.perf_counter()
        first = KeepFirstEpoch(self.snapshot, self.traffic["trainer"]["log_every_n_steps"])
        self.log = self.fit(self.epochs, "window", [first], log_every=1)
        wall = time.perf_counter() - t0
        steps = self.epochs * self.steps_per_epoch
        self.win = dict(wall_s=wall, epochs=self.epochs, rows=self.epochs * self.n_train,
                        steps=steps, val_rows=self.epochs * len(self.dm.X_test))
        return self.win

    def end_to_end(self, setup_s: float) -> dict:
        return {"train_samples_per_s": {"value": self.win["rows"] / self.win["wall_s"],
                                        "unit": "samples/s"},
                "setup_s": {"value": setup_s, "unit": "s"}}

    def attempted(self) -> tuple[int, int]:
        return self.win["steps"], 0

    def traced(self, profile) -> dict:
        """The traced segment: the second epoch of a two-epoch fit (the first,
        which captures the step graphs, runs untraced), steps, validation,
        checkpoint and resume snapshot.  Returns the profiler, the epoch's
        steps, the counters the completeness check holds the trace to, and
        the shapes of the launches for the bounds."""
        from fdtpu_torch.kernels import blockdiag_attention as bda

        counts, device = {}, self.device
        prof = torch.profiler.profile(activities=tr_activities(device))
        window = torch.profiler.record_function(tr_window)

        class SecondEpoch:
            """Trace from the first epoch's end to the second's."""

            def on_train_epoch_end(self, trainer, network, epoch):
                counts[epoch] = (bda.launches, bda.launches_bwd)
                if epoch == 0:
                    prof.start()
                    window.__enter__()
                else:
                    _sync(device)
                    window.__exit__(None, None, None)
                    prof.stop()

        self.fit(2, "trace", [SecondEpoch()])
        m = self.model
        h, dh, layers, t = m["n_head"], m["d_model"] // m["n_head"], m["num_layers"], m["max_len"]
        train_rows = [min(self.batch, self.n_train - s) for s in range(0, self.n_train, self.batch)]
        n_val = len(self.dm.X_test)
        val_rows = [min(self.batch, n_val - s) for s in range(0, n_val, self.batch)]
        b1_shapes = [(b, t, h, dh, layers) for b in train_rows + val_rows]
        return dict(profiler=prof, steps=len(train_rows),
                    counted={"blockdiag_mha_fwd_kernel": counts[1][0] - counts[0][0],
                             "blockdiag_mha_bwd_kernel": counts[1][1] - counts[0][1]},
                    expected={"blockdiag_mha_fwd_kernel": sum(s[-1] for s in b1_shapes),
                              "blockdiag_mha_bwd_kernel": layers * len(train_rows)},
                    shapes={"b1": b1_shapes,
                            "b2": [(b, t, h, dh, layers) for b in train_rows]})

    # ------------------------------------------------------------- check
    def free(self) -> None:
        self.dm = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)

    def _judged(self) -> dict:
        """What the fit's first epoch produced: its step losses and val loss
        (its log) and its parameters and first moments (the snapshot)."""
        losses = [r["train/loss"] for r in self.log if r.get("epoch") == 0 and "train/loss" in r]
        val = [r["val/loss"] for r in self.log if r.get("epoch") == 0 and "val/loss" in r]
        state = torch.load(self.snapshot, map_location="cpu", weights_only=True)
        return dict(losses=losses, val_loss=val[0] if val else float("nan"),
                    params={k: state["network"][k] for k in self.names},
                    mu=dict(zip(self.names, state["optimizer"]["mu"], strict=True)))

    def _reference(self, tf32: bool) -> dict:
        keep = [i for i in range(self.data["raw_features"])
                if i not in self.data["dropped_features"]]
        xt, xv = ref_train.prepare(self.x_train, self.x_val, keep,
                                   self.config["fourier_transform"], self.config["standardize"])
        with precision(tf32):
            return ref_train.first_epoch(self.weights, self.names, self.model,
                                         self.config["sde"], xt, xv, self.batch, self.epochs,
                                         self.data["lr_max"], self.data["gradient_clip_val"],
                                         self.trainer_seed, self.loader_seed, self.device)

    def check(self, control: bool = False) -> dict:
        """The compared numbers.  ``loss_gap``: the widest relative gap of
        the losses of the first three steps.  ``change_gap`` and
        ``moment_gap``: per leaf, the gap between the norms of the
        parameter's change over the first epoch (of AdamW's first moment
        after it) and the reference's, over the reference's norm or the
        median leaf's, whichever is larger, at the worst leaf.  Leaves whose
        first gradient in the reference is under a thousandth of the median
        leaf's (rounding alone moves them under AdamW) are left out.  The
        later steps' losses and the val loss after the epoch are printed,
        not compared: rounding compounds over forty steps to what TF32 gives
        (PERF.md).  ``control``: the reference in TF32 in the program's
        place."""
        ref = self._reference(False)
        judged = self._reference(True) if control else self._judged()
        n = len(ref["losses"])
        lp = np.asarray(judged["losses"][:n] + [float("nan")] * (n - len(judged["losses"])))
        lr = np.asarray(ref["losses"])
        g1 = ref["grad1"]
        med_g = float(np.median(list(g1.values())))
        kept = [k for k in self.names if g1[k] >= 1e-3 * med_g]
        self.left_out = [k for k in self.names if k not in kept]
        w0 = {k: v.detach().cpu().double() for k, v in self.weights.items()}

        def leaf_gaps(prog: dict, refd: dict, base: dict | None) -> dict:
            def norm(d, k):
                v = d[k].detach().cpu().double()
                return float(torch.linalg.vector_norm(v - base[k] if base else v))

            pn = {k: norm(prog, k) for k in kept}
            rn = {k: norm(refd, k) for k in kept}
            med = float(np.median(list(rn.values())))
            return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in kept}

        def worst(gaps) -> float:
            values = np.asarray(list(gaps))
            return float(values.max()) if np.all(np.isfinite(values)) else float("inf")

        change = leaf_gaps(judged["params"], ref["params"], w0)
        moment = leaf_gaps(judged["mu"], ref["mu"], None)
        step_gaps = np.abs(lp - lr) / np.abs(lr)
        val_gap = abs(judged["val_loss"] - ref["val_loss"]) / abs(ref["val_loss"])
        print("portbench: train check", json.dumps(dict(
            control=control, step_gaps_first=step_gaps[:5].tolist(),
            epoch_step_gap_max=worst(step_gaps), val_gap=val_gap, left_out=self.left_out,
            change_worst=sorted(change.items(), key=lambda kv: -kv[1])[:3],
            moment_worst=sorted(moment.items(), key=lambda kv: -kv[1])[:3])),
            file=sys.stderr, flush=True)
        return {"loss_gap": worst(step_gaps[:3]), "change_gap": worst(change.values()),
                "moment_gap": worst(moment.values())}
