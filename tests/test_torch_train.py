"""Port parity: the training slice, fdtpu_torch against fdtpu on the CPU.

The JAX loss splits its key into (t, z, dropout); the port takes t and z
injected, so each test rebuilds z from the JAX key split and hands the same
numbers to both.  Tolerances: rtol 1e-5 for one loss; the learning-rate
schedule at rtol 1e-6 with atol 1e-7·lr_max (optax evaluates it in float32);
the clip at rtol 1e-6; 1e-4 for losses and parameters over three optimizer
steps (float32 sums taken in another order by two frameworks).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fdtpu.data.datamodules import SyntheticDatamodule as JaxSynthetic
from fdtpu.data.dataset import DiffusionDataset as JaxDataset
from fdtpu.data.dataset import NumpyLoader as JaxLoader
from fdtpu.diffusion import VPScheduler as JaxVP
from fdtpu.diffusion.losses import sde_loss as jax_sde_loss
from fdtpu.kernels import blockdiag_attention as jax_bda
from fdtpu.models import score_models as jsm
from fdtpu.train import state as jax_state
from fdtpu.train.trainer import get_training_params as jax_training_params
from fdtpu_torch.data import DiffusionDataset, NumpyLoader, SyntheticDatamodule
from fdtpu_torch.diffusion import VPScheduler, sde_loss
from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
from fdtpu_torch.sampling import DiffusionSampler
from fdtpu_torch.train import (
    Trainer,
    clip_by_global_norm_,
    get_training_params,
    make_lr_schedule,
    make_optimizer,
)
from fdtpu_torch.utils.convert import load_jax_variables, state_dict_to_jax_variables

TINY = dict(n_channels=1, max_len=16, d_model=12, num_layers=2, n_head=2, dim_feedforward=24)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX custom VJP's Pallas forward and backward in interpret mode,
    as tests/test_kernels.py runs them on the CPU."""
    fwd, bwd = jax_bda.blockdiag_mha, jax_bda.blockdiag_mha_bwd
    monkeypatch.setattr(
        jax_bda, "blockdiag_mha",
        lambda q, k, v, q_tile=256, interpret=False, shift=True: fwd(
            q, k, v, q_tile=q_tile, interpret=True, shift=shift),
    )
    monkeypatch.setattr(
        jax_bda, "blockdiag_mha_bwd",
        lambda q, k, v, g, interpret=False: bwd(q, k, v, g, interpret=True),
    )


def _pair(attention_impl="einsum", dropout=0.0, seed=0, backbone="transformer"):
    kw = dict(TINY, attention_impl=attention_impl, dropout=dropout, backbone=backbone, d_mlp=20)
    jcfg = jsm.ScoreModelConfig(**kw)
    variables = jax.tree.map(np.asarray, jsm.init_score_model(jax.random.PRNGKey(seed), jcfg))
    net = init_score_model(ScoreModelConfig(**kw), device="cpu")
    load_jax_variables(net, variables)
    return jcfg, variables, net


def _jax_apply(jcfg, constants):
    def apply_fn(params, xn, t, train, rngs):
        return jsm.score_apply({"params": params, "constants": constants}, jcfg, xn, t,
                               train=train, rngs=rngs)
    return apply_fn


def _z_of_key(key, shape):
    """The z that fdtpu's sde_loss draws from ``key``."""
    return np.array(jax.random.normal(jax.random.split(key, 3)[1], shape, jnp.float32))


def _batch(batch=4, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, TINY["max_len"], TINY["n_channels"])).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, batch).astype(np.float32)
    return x, t


def _schedulers():
    n = TINY["max_len"]
    return JaxVP(fourier_noise_scaling=True).with_noise_scaling(n), \
        VPScheduler(fourier_noise_scaling=True).with_noise_scaling(n, "cpu")


@pytest.mark.parametrize("likelihood_weighting", [False, True])
@pytest.mark.parametrize("reduce_mean", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_sde_loss_matches_jax(likelihood_weighting, reduce_mean, weighted):
    jcfg, variables, net = _pair()
    jsched, psched = _schedulers()
    x, t = _batch()
    key = jax.random.PRNGKey(7)
    w = np.array([1.0, 0.0, 1.0, 1.0], np.float32) if weighted else None
    kw = dict(reduce_mean=reduce_mean, likelihood_weighting=likelihood_weighting, train=False)
    want = jax_sde_loss(_jax_apply(jcfg, variables["constants"]), variables["params"], jsched,
                        jnp.asarray(x), key, timesteps=jnp.asarray(t),
                        sample_weight=None if w is None else jnp.asarray(w), **kw)
    got = sde_loss(net, psched, torch.from_numpy(x), timesteps=torch.from_numpy(t),
                   noise=torch.from_numpy(_z_of_key(key, x.shape)),
                   sample_weight=None if w is None else torch.from_numpy(w), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_sde_loss_draws_t_and_z_from_the_generator():
    _, _, net = _pair()
    _, psched = _schedulers()
    x = torch.from_numpy(_batch()[0])
    a = sde_loss(net, psched, x, generator=torch.Generator().manual_seed(3))
    b = sde_loss(net, psched, x, generator=torch.Generator().manual_seed(3))
    c = sde_loss(net, psched, x, generator=torch.Generator().manual_seed(4))
    assert float(a) == float(b) != float(c)
    with pytest.raises(ValueError, match="generator"):
        sde_loss(net, psched, x)


@pytest.mark.parametrize("num_training_steps", [5, 40])
def test_lr_schedule_matches_optax(num_training_steps):
    lr_max = 1e-3
    want = jax_state.make_lr_schedule(lr_max, num_training_steps)
    got = make_lr_schedule(lr_max, num_training_steps)
    steps = range(num_training_steps + 3)
    np.testing.assert_allclose([got(k) for k in steps], [float(want(k)) for k in steps],
                               rtol=1e-6, atol=1e-7 * lr_max)
    assert got(0) == 0.0 and got(num_training_steps + 2) == 0.0


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["below-threshold", "above-threshold"])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.default_rng(5)
    grads = [scale * rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    tensors = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(tensors, 1.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    for g, w in zip(tensors, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)
    if scale < 1:
        for g, raw in zip(tensors, grads):
            np.testing.assert_array_equal(g.numpy(), raw)


def _first_divergence(got: dict, want: dict, atol: float, prefix: str = "") -> str | None:
    for name in sorted(want):
        g, w = got[name], want[name]
        if isinstance(w, dict):
            found = _first_divergence(g, w, atol, f"{prefix}{name}/")
            if found:
                return found
            continue
        diff = np.abs(np.asarray(g) - np.asarray(w))
        if diff.max() > atol:
            idx = np.unravel_index(diff.argmax(), diff.shape)
            return f"{prefix}{name}{list(idx)}: port {g[idx]!r} vs jax {w[idx]!r}"
    return None


@pytest.mark.parametrize("impl", ["einsum", "blockdiag", "mlp", "lstm"])
def test_three_optimizer_steps_match_jax(pallas_interpret, impl):
    """The transformer at both attention paths, and the MLP and LSTM
    backbones (``impl`` names the backbone)."""
    if impl in ("mlp", "lstm"):
        jcfg, variables, net = _pair(backbone=impl)
    else:
        jcfg, variables, net = _pair(impl)
    net.train().requires_grad_(True)
    jsched, psched = _schedulers()
    x, _ = _batch()
    num_training_steps, lr_max = 10, 1e-3
    tx = jax_state.make_optimizer(lr_max, num_training_steps)
    params = variables["params"]
    opt_state = tx.init(params)
    apply_fn = _jax_apply(jcfg, variables["constants"])
    optimizer = make_optimizer(net.parameters(), lr_max, num_training_steps)

    @jax.jit
    def jax_step(params, opt_state, key, t):
        def loss_fn(p):
            return jax_sde_loss(apply_fn, p, jsched, jnp.asarray(x), key, timesteps=t,
                                train=True)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    for step in range(3):
        key = jax.random.PRNGKey(100 + step)
        t = _batch(seed=10 + step)[1]
        params, opt_state, want = jax_step(params, opt_state, key, jnp.asarray(t))

        got = sde_loss(net, psched, torch.from_numpy(x), timesteps=torch.from_numpy(t),
                       noise=torch.from_numpy(_z_of_key(key, x.shape)), train=True)
        optimizer.zero_grad()
        got.backward()
        optimizer.step()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4,
                                   err_msg=f"step {step}")

    port = state_dict_to_jax_variables(net.state_dict())["params"]
    divergence = _first_divergence(port, jax.tree.map(np.asarray, params), atol=1e-4)
    assert divergence is None, f"first parameter past 1e-4: {divergence}"


def test_numpy_loader_batches_are_bit_identical_to_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 8, 2)).astype(np.float32)
    pj = JaxLoader(JaxDataset(x, standardize=True), 10, shuffle=True, seed=3)
    pp = NumpyLoader(DiffusionDataset(x, standardize=True), 10, shuffle=True, seed=3)
    assert len(pp) == len(pj) == 4
    for _ in range(2):  # each epoch draws a new permutation
        batches = list(pp)
        assert [len(b) for b in batches] == [10, 10, 10, 7]
        for a, b in zip(batches, pj):
            np.testing.assert_array_equal(a, b)
    pj.skip_epochs(2)
    pp.skip_epochs(2)
    for a, b in zip(pp, pj):
        np.testing.assert_array_equal(a, b)
    ds = DiffusionDataset(x, standardize=True)
    assert len(ds) == 37
    np.testing.assert_array_equal(ds[5]["X"], JaxDataset(x, standardize=True)[5]["X"])


def test_datamodule_loaders_and_parameters_match_jax(tmp_path):
    kw = dict(max_len=16, num_samples=50, batch_size=16, fourier_transform=True,
              standardize=True, random_seed=3)
    j = JaxSynthetic(data_dir=tmp_path / "jax", **kw)
    p = SyntheticDatamodule(tmp_path / "port", **kw)
    for dm in (j, p):
        dm.prepare_data()
        dm.setup()
    assert p.dataset_parameters == j.dataset_parameters
    assert get_training_params(p, 3) == jax_training_params(j, 3)
    for pl, jl in ((p.val_dataloader(), j.val_dataloader()),
                   (p.test_dataloader(), j.test_dataloader()),
                   (p.train_dataloader(), j.train_dataloader())):
        pb, jb = list(pl), list(jl)
        assert [b.shape for b in pb] == [b.shape for b in jb]
        for a, b in zip(pb, jb):
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_dropout_is_drawn_from_the_generator_and_off_in_eval():
    _, _, net = _pair(dropout=0.1)
    x, t = (torch.from_numpy(a) for a in _batch())

    def run(train, seed):
        return net(x, t, train=train, generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(False, 0), run(False, 1), rtol=0, atol=0)
    torch.testing.assert_close(run(True, 0), run(True, 0), rtol=0, atol=0)
    assert not torch.allclose(run(True, 0), run(False, 0))
    assert not torch.allclose(run(True, 0), run(True, 1))
    torch.testing.assert_close(net(x, t, train=True), run(False, 0), rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["einsum", "blockdiag"])
def test_trainer_fit_on_cpu(tmp_path, impl):
    dm = SyntheticDatamodule(tmp_path / "data", max_len=16, num_samples=40, batch_size=16,
                             fourier_transform=True, standardize=True)
    dm.prepare_data()
    dm.setup()
    cfg = ScoreModelConfig(**dict(TINY, attention_impl=impl))
    scheduler = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(16, "cpu")
    net = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = {k: v.clone() for k, v in net.state_dict().items()}
    model = ScoreModel(cfg, net, scheduler,
                       num_training_steps=get_training_params(dm, 2)["num_training_steps"])
    trainer = Trainer(max_epochs=2, run_dir=tmp_path / "runs", run_id="r", seed=1,
                      log_every_n_steps=2)
    assert trainer.fit(model, dm) is model

    records = [json.loads(line) for line in trainer.metrics_path.read_text().splitlines()]
    epochs = [r for r in records if "val/loss" in r]
    steps = [r for r in records if "train/loss" in r]
    assert [r["epoch"] for r in epochs] == [0, 1] and len(steps) == 3
    assert set(epochs[0]) == {"step", "epoch", "train/loss_epoch", "val/loss", "epoch_time_s", "lr"}
    assert set(steps[0]) == {"step", "epoch", "train/loss", "lr"}
    losses = [r[k] for r in records for k in ("train/loss", "train/loss_epoch", "val/loss") if k in r]
    assert np.isfinite(losses).all()
    assert trainer.best_val_loss == min(r["val/loss"] for r in epochs)

    trained = model.network
    assert trained is not net and not trained.training
    assert not any(p.requires_grad for p in trained.parameters())
    assert any(not torch.equal(v, before[k]) for k, v in trained.state_dict().items())
    torch.testing.assert_close(net.state_dict(), before, rtol=0, atol=0)
    samples = DiffusionSampler(model, 4).sample(4, 20, generator=torch.Generator().manual_seed(0))
    assert samples.shape == (4, 16, 1) and bool(torch.isfinite(samples).all())


def test_trainer_keeps_the_best_val_parameters(tmp_path, monkeypatch):
    """With val losses 0.5 then 0.9 the returned network holds epoch 0's
    parameters, as the JAX trainer keeps the best checkpoint."""
    dm = SyntheticDatamodule(tmp_path / "data", max_len=16, num_samples=16, batch_size=16)
    dm.prepare_data()
    dm.setup()
    cfg = ScoreModelConfig(**TINY)
    net = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    model = ScoreModel(cfg, net, VPScheduler().with_noise_scaling(16, "cpu"),
                       num_training_steps=4)
    from fdtpu_torch.train import trainer as trainer_mod

    snapshots, vals = [], iter([0.5, 0.9])
    real_loss = trainer_mod.sde_loss

    def fake_loss(network, *args, train=True, **kw):
        if train:
            return real_loss(network, *args, train=train, **kw)
        snapshots.append({k: v.clone() for k, v in network.state_dict().items()})
        return torch.tensor(next(vals))

    monkeypatch.setattr(trainer_mod, "sde_loss", fake_loss)
    trainer = Trainer(max_epochs=2, run_dir=tmp_path, run_id="r", seed=0)
    trainer.fit(model, dm)
    assert trainer.best_val_loss == 0.5
    torch.testing.assert_close(model.network.state_dict(), snapshots[0], rtol=0, atol=0)
    assert not all(torch.equal(snapshots[0][k], v) for k, v in snapshots[1].items())


def test_scheduler_add_noise_matches_jax():
    jsched, psched = _schedulers()
    x, t = _batch()
    noise = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    want = jsched.add_noise(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t))
    got = psched.add_noise(torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert dataclasses.is_dataclass(psched) and psched.T == jsched.T == 1.0


def _fit_port(tmp_path, dm, steps_per_call, dropout=0.1, net=None, run_id=None):
    cfg = ScoreModelConfig(**dict(TINY, dropout=dropout))
    scheduler = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(16, "cpu")
    if net is None:
        net = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    model = ScoreModel(cfg, net, scheduler,
                       num_training_steps=get_training_params(dm, 2)["num_training_steps"])
    trainer = Trainer(max_epochs=2, run_dir=tmp_path / "runs", run_id=run_id or f"spc{steps_per_call}",
                      seed=1, log_every_n_steps=1, steps_per_call=steps_per_call)
    return trainer.fit(model, dm), trainer


def _records(trainer):
    return [json.loads(line) for line in trainer.metrics_path.read_text().splitlines()]


@pytest.fixture
def odd_datamodule(tmp_path):
    """Train batches of 16 with a shorter last one, so a group of
    same-shape steps ends before the odd batch."""
    dm = SyntheticDatamodule(tmp_path / "data", max_len=16, num_samples=90, batch_size=16,
                             fourier_transform=True, standardize=True, random_seed=2)
    dm.prepare_data()
    dm.setup()
    shapes = [b.shape[0] for b in dm.train_dataloader()]
    assert len(set(shapes)) == 2 and shapes[-1] < shapes[0] and len(shapes) >= 3
    return dm


def test_trainer_steps_per_call_gives_the_per_step_trajectory(tmp_path, odd_datamodule):
    """``steps_per_call=16`` against 1, dropout on: the JAX chunking test's
    tolerances (tests/test_trainer_chunked.py) — parameters rtol 2e-5 /
    atol 2e-6, per-step losses and the val loss rtol 2e-4."""
    one, t1 = _fit_port(tmp_path, odd_datamodule, 1)
    many, tk = _fit_port(tmp_path, odd_datamodule, 16)
    for (name, a), b in zip(one.network.state_dict().items(), many.network.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-5, atol=2e-6, err_msg=name)
    r1, rk = _records(t1), _records(tk)
    step_losses = [{r["step"]: r["train/loss"] for r in rs if "train/loss" in r} for rs in (r1, rk)]
    assert step_losses[0].keys() == step_losses[1].keys() and len(step_losses[0]) >= 6
    for s in step_losses[0]:
        np.testing.assert_allclose(step_losses[1][s], step_losses[0][s], rtol=2e-4, err_msg=s)
    assert tk.best_val_loss == pytest.approx(t1.best_val_loss, rel=2e-4)
    assert [r.get("lr") for r in rk] == [r.get("lr") for r in r1]


def test_trainer_steps_per_call_matches_jax(tmp_path, odd_datamodule, monkeypatch):
    """The port's ``Trainer(steps_per_call=16)`` against the JAX package's
    over two epochs, dropout off, with the JAX step keys' t and z handed to
    every train and val loss (per step ``key, step_key = split(key)``, then
    ``split(step_key, 3)`` for t and z): per-step losses, val losses, rates
    and the best-val parameters at this file's tolerance (1e-4)."""
    from fdtpu.train.trainer import Trainer as JaxTrainer
    from fdtpu_torch.train import trainer as trainer_mod

    jcfg, variables, net = _pair(dropout=0.0)
    dm = odd_datamodule
    j_dm = JaxSynthetic(data_dir=tmp_path / "jaxdata", max_len=16, num_samples=90,
                        batch_size=16, fourier_transform=True, standardize=True, random_seed=2)
    j_dm.prepare_data()
    j_dm.setup()
    n_steps = get_training_params(dm, 2)["num_training_steps"]
    jmodel = jsm.ScoreModel(config=jcfg, variables=variables,
                            scheduler=_schedulers()[0], num_training_steps=n_steps)
    jtrainer = JaxTrainer(max_epochs=2, run_dir=tmp_path / "jax", run_id="j", seed=1,
                          log_every_n_steps=1, steps_per_call=16, use_mesh=False,
                          save_resume_state=False)
    jmodel = jtrainer.fit(jmodel, j_dm)

    def step_keys():
        key = jax.random.PRNGKey(1)
        while True:
            key, step_key = jax.random.split(key)
            yield step_key

    keys, real_loss = step_keys(), trainer_mod.sde_loss

    def jax_draws_loss(network, scheduler, x, generator=None, **kw):
        key_t, key_z, _ = jax.random.split(next(keys), 3)
        t = jax.random.uniform(key_t, (x.shape[0],), jnp.float32) * (1.0 - 1e-5) + 1e-5
        z = jax.random.normal(key_z, tuple(x.shape), jnp.float32)
        return real_loss(network, scheduler, x, timesteps=torch.from_numpy(np.array(t)),
                         noise=torch.from_numpy(np.array(z)), **kw)

    monkeypatch.setattr(trainer_mod, "sde_loss", jax_draws_loss)
    model, trainer = _fit_port(tmp_path, dm, 16, dropout=0.0, net=net, run_id="port")
    got, want = _records(trainer), _records(jtrainer)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        assert g["step"] == w["step"] and g["epoch"] == w["epoch"]
        for k in ("train/loss", "train/loss_epoch", "val/loss"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"{k} at {w['step']}")
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6, atol=1e-10)
    port = state_dict_to_jax_variables(model.network.state_dict())["params"]
    divergence = _first_divergence(port, jax.tree.map(np.asarray, jmodel.variables["params"]),
                                   atol=1e-4)
    assert divergence is None, f"first parameter past 1e-4: {divergence}"


class _JaxDeviceDraws:
    """The draws of the JAX device loop (``_fit_on_device``) from
    ``PRNGKey(seed)``, in its order: per epoch ``key, pkey = split(key)`` and
    the permutation of ``pkey``; per train and val loss ``key, sk =
    split(key)`` and the t and z of ``split(sk, 3)``."""

    def __init__(self, seed, real_loss):
        self.key, self.real_loss = jax.random.PRNGKey(seed), real_loss

    def permutation(self, n, generator):
        self.key, pkey = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.permutation(pkey, n)).astype(np.int64))

    def loss(self, network, scheduler, x, generator=None, **kw):
        self.key, sk = jax.random.split(self.key)
        key_t, key_z, _ = jax.random.split(sk, 3)
        t = jax.random.uniform(key_t, (x.shape[0],), jnp.float32) * (1.0 - 1e-5) + 1e-5
        z = jax.random.normal(key_z, tuple(x.shape), jnp.float32)
        return self.real_loss(network, scheduler, x, timesteps=torch.from_numpy(np.array(t)),
                              noise=torch.from_numpy(np.array(z)), **kw)


def _fit_resident(tmp_path, dm, epochs, per_call, run_id, net=None, dropout=0.0, accumulate=1,
                  horizon=None, **trainer_kw):
    cfg = ScoreModelConfig(**dict(TINY, dropout=dropout))
    if net is None:
        net = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    n_steps = get_training_params(dm, horizon or epochs, accumulate)["num_training_steps"]
    model = ScoreModel(cfg, net, _schedulers()[1], num_training_steps=n_steps)
    trainer = Trainer(max_epochs=epochs, run_dir=tmp_path / "runs", run_id=run_id, seed=1,
                      log_every_n_steps=1, epochs_per_call=per_call,
                      accumulate_grad_batches=accumulate, **trainer_kw)
    return trainer.fit(model, dm), trainer


@pytest.mark.parametrize("accumulate", [1, 2])
def test_resident_epochs_match_jax_fit_on_device(tmp_path, odd_datamodule, monkeypatch,
                                                 accumulate):
    """``Trainer(epochs_per_call=2)`` over three epochs (two calls, the
    second shorter: JAX masks its tail, the port takes a one-epoch graph)
    against the JAX package's ``_fit_on_device``, dropout off, the JAX
    permutations, t and z handed in: a partial last batch (90 train rows in
    batches of 16), the best checkpoint, ``accumulate_grad_batches`` 1 and 2;
    per-step losses, val losses, rates, the best val loss and its epoch, and
    the best-val parameters at this file's tolerance (1e-4)."""
    from fdtpu.train.trainer import Trainer as JaxTrainer
    from fdtpu_torch.train import trainer as trainer_mod

    jcfg, variables, net = _pair(dropout=0.0)
    dm = odd_datamodule
    assert len(dm.train_dataloader().dataset) % dm.batch_size
    j_dm = JaxSynthetic(data_dir=tmp_path / "jaxdata", max_len=16, num_samples=90,
                        batch_size=16, fourier_transform=True, standardize=True, random_seed=2)
    j_dm.prepare_data()
    j_dm.setup()
    n_steps = get_training_params(dm, 3, accumulate)["num_training_steps"]
    jmodel = jsm.ScoreModel(config=jcfg, variables=variables,
                            scheduler=_schedulers()[0], num_training_steps=n_steps)
    jtrainer = JaxTrainer(max_epochs=3, run_dir=tmp_path / "jax", run_id="j", seed=1,
                          log_every_n_steps=1, epochs_per_call=2, use_mesh=False,
                          save_resume_state=False, accumulate_grad_batches=accumulate)
    jmodel = jtrainer.fit(jmodel, j_dm)

    draws = _JaxDeviceDraws(1, trainer_mod.sde_loss)
    monkeypatch.setattr(trainer_mod, "sde_loss", draws.loss)
    monkeypatch.setattr(trainer_mod, "draw_permutation", draws.permutation)
    model, trainer = _fit_resident(tmp_path, dm, 3, 2, "port", net=net, accumulate=accumulate)
    got, want = _records(trainer), _records(jtrainer)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert sum("val/loss" in r for r in got) == 3
    for g, w in zip(got, want):
        assert g["step"] == w["step"] and g["epoch"] == w["epoch"]
        for key in ("train/loss", "train/loss_epoch", "val/loss"):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4, err_msg=f"{key} {w['step']}")
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6, atol=1e-10)
    assert trainer.best_val_loss == pytest.approx(jtrainer.best_val_loss, rel=1e-4)
    assert trainer.best_checkpoint.name.split("-")[0] == jtrainer.best_checkpoint.name.split("-")[0]
    port = state_dict_to_jax_variables(model.network.state_dict())["params"]
    divergence = _first_divergence(port, jax.tree.map(np.asarray, jmodel.variables["params"]),
                                   atol=1e-4)
    assert divergence is None, f"first parameter past 1e-4: {divergence}"


def _epoch_records(trainer):
    return {r["epoch"]: (r["train/loss_epoch"], r["val/loss"]) for r in _records(trainer)
            if "val/loss" in r}


def test_resident_epochs_do_not_depend_on_epochs_per_call(tmp_path, odd_datamodule):
    """Four epochs, dropout on, at ``epochs_per_call`` 2 and 3 (tests/
    test_trainer_device.py's invariant): the same draws in the same order,
    so on the CPU the same losses, best val loss and parameters exactly."""
    runs = {k: _fit_resident(tmp_path, odd_datamodule, 4, k, f"k{k}", dropout=0.1)
            for k in (2, 3)}
    (m2, t2), (m3, t3) = runs[2], runs[3]
    assert _epoch_records(t2) == _epoch_records(t3) and len(_epoch_records(t2)) == 4
    assert [r for r in _records(t2) if "train/loss" in r] == \
        [r for r in _records(t3) if "train/loss" in r]
    assert t2.best_val_loss == t3.best_val_loss == min(v for _, v in _epoch_records(t2).values())
    for a, b in zip(m2.network.state_dict().values(), m3.network.state_dict().values()):
        assert torch.equal(a, b)


def test_resident_epochs_resume_reproduces_the_trajectory(tmp_path, odd_datamodule):
    """Two epochs, then ``resume=True`` up to four, against four straight
    (``epochs_per_call=2``, dropout on): the resumed epochs' losses, the best
    val loss and the returned parameters exactly (the CPU runs the same
    operations)."""
    m_full, t_full = _fit_resident(tmp_path, odd_datamodule, 4, 2, "full", dropout=0.1)
    _fit_resident(tmp_path, odd_datamodule, 2, 2, "part", dropout=0.1, horizon=4)
    m_part, t_part = _fit_resident(tmp_path, odd_datamodule, 4, 2, "part", dropout=0.1,
                                   resume=True)
    full, part = _epoch_records(t_full), _epoch_records(t_part)
    assert set(part) == {0, 1, 2, 3} and part == full
    assert t_part.best_val_loss == t_full.best_val_loss
    for a, b in zip(m_full.network.state_dict().values(), m_part.network.state_dict().values()):
        assert torch.equal(a, b)


def test_resident_epochs_are_freed_when_the_fit_returns(tmp_path, odd_datamodule, monkeypatch):
    """The epoch loop keeps no reference to itself: it is freed (and on a
    card its graphs) when ``fit`` returns, with the garbage collector off,
    not at a later collection inside another graph's capture."""
    import gc
    import weakref

    from fdtpu_torch.train import trainer as trainer_mod

    refs = []
    real_init = trainer_mod.ResidentEpochs.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        refs.append(weakref.ref(self))

    monkeypatch.setattr(trainer_mod.ResidentEpochs, "__init__", init)
    gc.disable()
    try:
        _fit_resident(tmp_path, odd_datamodule, 2, 2, "freed")
        assert len(refs) == 1 and refs[0]() is None
    finally:
        gc.enable()


def test_padded_weights_give_the_mean_over_the_real_rows():
    """A partial batch padded with zero-weight rows: the loss and its
    gradient are those of the real rows alone (``padded_weights``): the loss
    at rtol 1e-6, the gradients at rtol 1e-5 / atol 1e-8 (float32 sums over
    another number of rows)."""
    from fdtpu_torch.train.trainer import padded_weights

    _, _, net = _pair()
    net.requires_grad_(True)
    _, psched = _schedulers()
    x, t = (torch.from_numpy(a) for a in _batch(batch=6, seed=4))
    z = torch.from_numpy(np.random.default_rng(5).standard_normal(x.shape).astype(np.float32))
    w = torch.from_numpy(padded_weights(4, 1, 6)[0])
    assert w.tolist() == [1, 1, 1, 1, 0, 0]
    grads = []
    for rows, weight in ((slice(0, 6), w), (slice(0, 4), None)):
        net.zero_grad()
        loss = sde_loss(net, psched, x[rows], timesteps=t[rows], noise=z[rows],
                        sample_weight=weight)
        loss.backward()
        grads.append((loss.detach(), [p.grad.clone() for p in net.parameters()]))
    (l6, g6), (l4, g4) = grads
    torch.testing.assert_close(l6, l4, rtol=1e-6, atol=0)
    for a, b in zip(g6, g4):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("accumulate", [1, 2, 3])
def test_get_training_params_divides_as_jax(tmp_path, accumulate):
    dm = SyntheticDatamodule(tmp_path / "data", max_len=16, num_samples=70, batch_size=16)
    dm.prepare_data()
    dm.setup()
    assert get_training_params(dm, 3, accumulate) == jax_training_params(dm, 3, accumulate)


@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_optax_multisteps(k):
    """``ClippedAdamW(accumulate_grad_batches=k)`` against
    ``optax.MultiSteps`` over 2k + 1 micro-steps of random gradients (the
    norm above the clip on some): parameters at every micro-step (rtol 1e-6,
    atol 1e-9), one update and one schedule step per k micro-steps."""
    rng = np.random.default_rng(k)
    shapes = ((3, 4), (5,))
    params = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    tx = jax_state.make_optimizer(1e-2, 10, accumulate_grad_batches=k)
    jparams = [jnp.asarray(a) for a in params]
    state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in params]
    opt = make_optimizer(tparams, 1e-2, 10, accumulate_grad_batches=k)
    for step in range(2 * k + 1):
        grads = [rng.standard_normal(sh).astype(np.float32) * (3.0 if step % 2 else 0.1)
                 for sh in shapes]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p_, g in zip(tparams, grads):
            p_.grad = torch.from_numpy(g)
        opt.step()
        for got, want in zip(tparams, jparams):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-9, err_msg=f"micro-step {step}")
        assert opt.mini_step == int(state.mini_step)
        assert opt.count == int(opt.updates) == int(state.gradient_step)


@pytest.fixture
def five_batch_datamodule(tmp_path):
    """Five train batches an epoch, the last shorter: with two micro-steps
    an update, an update spans the epoch boundary."""
    dm = SyntheticDatamodule(tmp_path / "data5", max_len=16, num_samples=70, batch_size=16,
                             fourier_transform=True, standardize=True, random_seed=3)
    dm.prepare_data()
    dm.setup()
    assert [b.shape[0] for b in dm.train_dataloader()] == [16, 16, 16, 16, 6]
    return dm


def test_trainer_accumulation_matches_jax_across_epochs(tmp_path, five_batch_datamodule,
                                                        monkeypatch):
    """``accumulate_grad_batches=2`` over two epochs of five batches
    against the JAX trainer (``optax.MultiSteps``, whose micro-step count
    carries over the epoch boundary), at ``steps_per_call=16``, with the JAX
    step keys' t and z handed to every loss: per-step losses, val losses,
    rates and the best-val parameters at this file's tolerance (1e-4)."""
    from fdtpu.train.trainer import Trainer as JaxTrainer
    from fdtpu_torch.train import trainer as trainer_mod

    jcfg, variables, net = _pair(dropout=0.0)
    dm = five_batch_datamodule
    j_dm = JaxSynthetic(data_dir=tmp_path / "jaxdata", max_len=16, num_samples=70,
                        batch_size=16, fourier_transform=True, standardize=True, random_seed=3)
    j_dm.prepare_data()
    j_dm.setup()
    n_steps = get_training_params(dm, 2, 2)["num_training_steps"]
    assert n_steps == 5
    jmodel = jsm.ScoreModel(config=jcfg, variables=variables,
                            scheduler=_schedulers()[0], num_training_steps=n_steps)
    jtrainer = JaxTrainer(max_epochs=2, run_dir=tmp_path / "jax", run_id="j", seed=1,
                          log_every_n_steps=1, steps_per_call=16, use_mesh=False,
                          save_resume_state=False, accumulate_grad_batches=2)
    jmodel = jtrainer.fit(jmodel, j_dm)

    def step_keys():
        key = jax.random.PRNGKey(1)
        while True:
            key, step_key = jax.random.split(key)
            yield step_key

    keys, real_loss = step_keys(), trainer_mod.sde_loss

    def jax_draws_loss(network, scheduler, x, generator=None, **kw):
        key_t, key_z, _ = jax.random.split(next(keys), 3)
        t = jax.random.uniform(key_t, (x.shape[0],), jnp.float32) * (1.0 - 1e-5) + 1e-5
        z = jax.random.normal(key_z, tuple(x.shape), jnp.float32)
        return real_loss(network, scheduler, x, timesteps=torch.from_numpy(np.array(t)),
                         noise=torch.from_numpy(np.array(z)), **kw)

    monkeypatch.setattr(trainer_mod, "sde_loss", jax_draws_loss)
    model = ScoreModel(ScoreModelConfig(**dict(TINY, dropout=0.0)), net,
                       _schedulers()[1], num_training_steps=n_steps)
    trainer = Trainer(max_epochs=2, run_dir=tmp_path / "runs", run_id="port", seed=1,
                      log_every_n_steps=1, steps_per_call=16, accumulate_grad_batches=2)
    model = trainer.fit(model, dm)
    got, want = _records(trainer), _records(jtrainer)
    assert [sorted(r) for r in got] == [sorted(r) for r in want] and len(got) == 12
    for g, w in zip(got, want):
        assert g["step"] == w["step"] and g["epoch"] == w["epoch"]
        for key in ("train/loss", "train/loss_epoch", "val/loss"):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4, err_msg=f"{key} {w['step']}")
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6, atol=1e-10)
    port = state_dict_to_jax_variables(model.network.state_dict())["params"]
    divergence = _first_divergence(port, jax.tree.map(np.asarray, jmodel.variables["params"]),
                                   atol=1e-4)
    assert divergence is None, f"first parameter past 1e-4: {divergence}"


def test_trainer_accumulation_is_the_same_for_every_steps_per_call(tmp_path,
                                                                   five_batch_datamodule):
    """At ``accumulate_grad_batches=2`` the grouped steps (two step graphs a
    shape on the card, keyed on whether the micro-step updates) give the
    per-step loop's trajectory: bitwise on the CPU, where both run the same
    operations."""
    fits = []
    for spc in (1, 16):
        cfg = ScoreModelConfig(**TINY)
        net = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
        model = ScoreModel(cfg, net, _schedulers()[1], num_training_steps=5)
        trainer = Trainer(max_epochs=2, run_dir=tmp_path, run_id=f"acc{spc}", seed=1,
                          log_every_n_steps=1, steps_per_call=spc, accumulate_grad_batches=2)
        fits.append((trainer.fit(model, five_batch_datamodule), _records(trainer)))
    (m1, r1), (m16, r16) = fits
    torch.testing.assert_close(m16.network.state_dict(), m1.network.state_dict(), rtol=0, atol=0)
    assert r16 == [dict(r, epoch_time_s=r16[i].get("epoch_time_s")) if "epoch_time_s" in r
                   else r for i, r in enumerate(r1)]
