"""Port parity: checkpoints, exact resume and the training callbacks,
fdtpu_torch against fdtpu on the CPU.

Resume is held to the uninterrupted run bitwise (the same data order, the
same generator draws, the same optimizer state, on the same device).  A
checkpoint written by the JAX package reaches the port through its own
reader and ``load_jax_variables`` and scores as the JAX model does at atol
2e-5 (tests/test_torch_models.py's einsum tolerance).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.diffusion import VPScheduler as JaxVP
from fdtpu.metrics import MarginalWasserstein as JaxMW
from fdtpu.metrics import SlicedWasserstein as JaxSW
from fdtpu.models import score_models as jsm
from fdtpu.train import checkpoint as jax_ckpt
from fdtpu_torch.data import SyntheticDatamodule
from fdtpu_torch.diffusion import VPScheduler
from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
from fdtpu_torch.train import Trainer, get_training_params
from fdtpu_torch.train import checkpoint as ckpt
from fdtpu_torch.train.callbacks import DiffusionMethodComparisonCallback, SamplingCallback
from fdtpu_torch.utils.convert import load_jax_variables

TINY = dict(n_channels=1, max_len=16, d_model=12, num_layers=2, n_head=2, dim_feedforward=24)


@pytest.fixture(scope="module")
def dm(tmp_path_factory):
    """Five train batches an epoch, the last shorter."""
    dm = SyntheticDatamodule(tmp_path_factory.mktemp("data"), max_len=16, num_samples=70,
                             batch_size=16, fourier_transform=True, standardize=True,
                             random_seed=3)
    dm.prepare_data()
    dm.setup()
    return dm


def _model(dm, accumulate=1, backbone="transformer"):
    cfg = ScoreModelConfig(**dict(TINY, backbone=backbone, d_mlp=20))
    net = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    scheduler = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(16, "cpu")
    return ScoreModel(cfg, net, scheduler,
                      num_training_steps=get_training_params(dm, 3, accumulate)["num_training_steps"])


def _fit(dm, run_dir, epochs, resume=False, spc=1, accumulate=1, callbacks=None):
    trainer = Trainer(max_epochs=epochs, run_dir=run_dir, run_id="run", seed=1,
                      log_every_n_steps=1, steps_per_call=spc, accumulate_grad_batches=accumulate,
                      resume=resume, callbacks=callbacks)
    return trainer.fit(_model(dm, accumulate), dm), trainer


def _records(trainer):
    return [json.loads(line) for line in trainer.metrics_path.read_text().splitlines()]


def _without_times(records):
    return [{k: v for k, v in r.items() if k != "epoch_time_s"} for r in records]


@pytest.mark.parametrize("spc, accumulate", [(1, 1), (16, 2)])
def test_resume_reproduces_the_uninterrupted_run_bitwise(tmp_path, dm, spc, accumulate):
    """Three epochs straight against one epoch, then a new trainer resuming
    to three, dropout on: every record (losses, val losses, rates), the
    returned best-val network and the last epoch's training state (network,
    optimizer with a half-accumulated mean at the epoch boundary, generator)
    are equal bitwise."""
    straight, t_full = _fit(dm, tmp_path / "full", 3, spc=spc, accumulate=accumulate)
    _, t_a = _fit(dm, tmp_path / "part", 1, spc=spc, accumulate=accumulate)
    resumed, t_b = _fit(dm, tmp_path / "part", 3, resume=True, spc=spc, accumulate=accumulate)
    assert _without_times(_records(t_b)) == _without_times(_records(t_full))
    assert t_b.best_val_loss == t_full.best_val_loss
    torch.testing.assert_close(resumed.network.state_dict(), straight.network.state_dict(),
                               rtol=0, atol=0)
    (s_full, m_full), (s_part, m_part) = (ckpt.load_train_state(t.run_dir) for t in (t_full, t_b))
    assert m_part == m_full == {"epoch": 2, "global_step": 15, "best_val_loss": t_full.best_val_loss}
    torch.testing.assert_close(s_part, s_full, rtol=0, atol=0)
    if accumulate > 1:
        assert s_full["optimizer"]["mini_step"] == 1 and s_full["optimizer"]["count"] == 7


def test_resume_without_a_snapshot_trains_from_scratch(tmp_path, dm):
    _, trainer = _fit(dm, tmp_path, 1, resume=True)
    assert np.isfinite(trainer.best_val_loss) and len(_records(trainer)) == 6


def test_trainer_writes_checkpoints_of_each_improvement(tmp_path, dm):
    model, trainer = _fit(dm, tmp_path, 3)
    epochs = [r for r in _records(trainer) if "val/loss" in r]
    best = min(range(3), key=lambda e: epochs[e]["val/loss"])
    improved = [e for e in range(3) if epochs[e]["val/loss"] == min(
        r["val/loss"] for r in epochs[:e + 1])]
    names = sorted(p.name for p in (trainer.run_dir / "checkpoints").glob("*.ckpt"))
    assert names == sorted(f"epoch={e}-val_loss={epochs[e]['val/loss']:.2f}.ckpt"
                           for e in improved)
    assert trainer.best_checkpoint == ckpt.get_best_checkpoint(trainer.run_dir / "checkpoints")
    assert json.loads((trainer.best_checkpoint / "meta.json").read_text())["epoch"] == best
    restored = ckpt.load_checkpoint(trainer.best_checkpoint, device="cpu")
    torch.testing.assert_close(restored.network.state_dict(), model.network.state_dict(),
                               rtol=0, atol=0)


def _jax_model(backbone="transformer"):
    jcfg = jsm.ScoreModelConfig(**dict(TINY, backbone=backbone, d_mlp=20))
    variables = jsm.init_score_model(jax.random.PRNGKey(4), jcfg)
    scheduler = JaxVP(fourier_noise_scaling=True).with_noise_scaling(16)
    return jsm.ScoreModel(config=jcfg, variables=variables, scheduler=scheduler,
                          num_training_steps=12, lr_max=2e-4)


@pytest.mark.parametrize("backbone", ["transformer", "lstm"])
def test_a_jax_checkpoint_scores_the_same_in_the_port(tmp_path, backbone):
    """``fdtpu.train.save_checkpoint`` (orbax), read back by the JAX package,
    carried over by ``load_jax_variables`` into the network the port builds
    from the same ``meta.json``."""
    jmodel = _jax_model(backbone)
    path = jax_ckpt.save_checkpoint(tmp_path, jmodel, epoch=3, val_loss=0.25)
    restored = jax_ckpt.load_checkpoint(path)
    meta = json.loads((path / "meta.json").read_text())
    net = init_score_model(ScoreModelConfig(**meta["model_config"]), device="cpu")
    load_jax_variables(net, jax.tree.map(np.asarray, restored.variables))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 16, 1)).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, 3).astype(np.float32)
    want = np.asarray(restored(jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(net(torch.from_numpy(x), torch.from_numpy(t)).numpy(), want,
                               atol=2e-5)
    scheduler = ckpt.scheduler_from_meta(meta["scheduler"], 16, "cpu")
    np.testing.assert_array_equal(scheduler.G.numpy(), np.asarray(restored.scheduler.G))


def test_port_checkpoints_keep_the_jax_layout_and_keys(tmp_path):
    jmodel = _jax_model()
    jax_dir = jax_ckpt.save_checkpoint(tmp_path / "jax", jmodel, epoch=3, val_loss=0.25)
    cfg = ScoreModelConfig(**dict(TINY, d_mlp=20))
    net = init_score_model(cfg, device="cpu")
    load_jax_variables(net, jax.tree.map(np.asarray, jmodel.variables))
    model = ScoreModel(cfg, net,
                       VPScheduler(fourier_noise_scaling=True).with_noise_scaling(16, "cpu"),
                       num_training_steps=12, lr_max=2e-4)
    port_dir = ckpt.save_checkpoint(tmp_path / "port", model, epoch=3, val_loss=0.25)
    assert port_dir.relative_to(tmp_path / "port") == jax_dir.relative_to(tmp_path / "jax")
    assert json.loads((port_dir / "meta.json").read_text()) == json.loads(
        (jax_dir / "meta.json").read_text())
    assert ckpt.scheduler_to_meta(model.scheduler) == jax_ckpt.scheduler_to_meta(jmodel.scheduler)
    restored = ckpt.load_checkpoint(port_dir, device="cpu", attention_impl="blockdiag")
    assert restored.config.attention_impl == "blockdiag"
    assert restored.network.backbone[0].attention_impl == "blockdiag"
    torch.testing.assert_close(restored.network.state_dict(), net.state_dict(), rtol=0, atol=0)
    assert (restored.num_training_steps, restored.lr_max) == (12, 2e-4)


def test_get_best_checkpoint_equals_jax(tmp_path):
    for name in ("epoch=0-val_loss=0.50.ckpt", "epoch=1-val_loss=0.31.ckpt",
                 "epoch=4-val_loss=0.31.ckpt", "epoch=2-val_loss=-0.10.ckpt",
                 "epoch=3-val_loss=nan.ckpt", "notes.ckpt", "epoch=5-val_loss=0.01"):
        (tmp_path / name).mkdir()
    assert ckpt.get_best_checkpoint(tmp_path) == jax_ckpt.get_best_checkpoint(tmp_path)
    assert ckpt.get_best_checkpoint(tmp_path).name == "epoch=2-val_loss=-0.10.ckpt"
    with pytest.raises(FileNotFoundError):
        ckpt.get_best_checkpoint(tmp_path / "epoch=0-val_loss=0.50.ckpt")


def test_callbacks_run_at_epoch_ends_and_log(tmp_path, dm):
    """The sampling callback's record has the JAX callback's keys; the
    method comparison times each method of
    ``configs/trainer/diffusion_comparison.yaml``'s kind."""
    template = _model(dm)
    sampling = SamplingCallback(dm, template, every_n_epochs=2, sample_batch_size=4,
                                num_samples=8, num_diffusion_steps=5, num_directions=10)
    methods = [{"name": "baseline", "num_diffusion_steps": 6, "use_cache": False},
               {"name": "cache_score", "num_diffusion_steps": 6, "use_cache": True,
                "cache_kwargs": {"level": "score", "R": 2, "guard": "off"}},
               {"name": "fresca", "num_diffusion_steps": 6, "use_fresca": True}]
    comparison = DiffusionMethodComparisonCallback(template, methods, num_samples=4,
                                                   sample_batch_size=4)
    _, trainer = _fit(dm, tmp_path, 2, callbacks=[sampling, comparison])
    records = _records(trainer)
    metric_records = [r for r in records if any(k.startswith("metrics/") for k in r)]
    assert [r["epoch"] for r in metric_records] == [1]
    rng = np.random.default_rng(0)
    fake = rng.standard_normal((8, 16, 1)).astype(np.float32)
    jax_metrics = (JaxSW(original_samples=dm.X_train, random_seed=42, num_directions=10),
                   JaxMW(original_samples=dm.X_train, random_seed=42))
    want = {"epoch"} | {f"metrics/{k}" for m in jax_metrics for k, v in m(fake).items()
                        if not isinstance(v, list)}
    assert set(metric_records[0]) == want
    assert all(np.isfinite(v) for k, v in metric_records[0].items())
    comparisons = [r["diffusion_comparison"] for r in records if "diffusion_comparison" in r]
    assert len(comparisons) == 2
    assert list(comparisons[0]) == ["baseline", "cache_score", "fresca"]
    assert comparisons[0]["cache_score"]["cache_stats"]["current_step"] == 6
    assert "speedup_vs_baseline" in comparisons[0]["fresca"]
