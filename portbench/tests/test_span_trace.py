"""The program's spans in the benchmark's trace reader, on the card: a fit
profiled with CPU and CUDA activity, the trainer's spans open as profiler
ranges, whose device-side annotations must not count as device work."""

import pytest


@pytest.mark.cuda
def test_profiled_training_spans_are_not_device_activity(cuda, tmp_path):
    import torch

    from fdtpu_torch.data import SyntheticDatamodule
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
    from fdtpu_torch.train import Trainer, get_training_params
    from portbench import trace as tr

    dm = SyntheticDatamodule(tmp_path / "data", max_len=33, num_samples=90, batch_size=16,
                             fourier_transform=True, standardize=True, random_seed=2)
    dm.prepare_data()
    dm.setup()
    cfg = ScoreModelConfig(n_channels=1, max_len=33, d_model=24, num_layers=2, n_head=4,
                           dim_feedforward=48, attention_impl="blockdiag", dropout=0.1)
    net = init_score_model(cfg, torch.Generator().manual_seed(0), cuda)
    sched = VPScheduler(fourier_noise_scaling=True, beta_max=2.0).with_noise_scaling(33, cuda)
    model = ScoreModel(config=cfg, network=net, scheduler=sched,
                       num_training_steps=get_training_params(dm, 2)["num_training_steps"])
    trainer = Trainer(max_epochs=2, run_dir=tmp_path / "runs", run_id="p", seed=3)
    prof = tr.profile(lambda: trainer.fit(model, dm), cuda)
    host = {e.name for e in prof.events() if not tr._is_device(e)}
    assert {"fdtpu.fit", "fdtpu.fit.epoch", "fdtpu.fit.steps", "fdtpu.fit.epoch_end"} <= host
    summary = tr.summarize(prof)
    assert summary["busy_s"] > 0
    assert not [k for k in summary["kernels"] if k.startswith("fdtpu.")]
    assert not [k for k, _ in summary["device_ops"] if k.startswith("fdtpu.")]
