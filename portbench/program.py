"""The system under test, built from a configuration file: the port's
``ScoreModel`` with the benchmark's weights loaded into its network."""

from __future__ import annotations

MODEL_KEYS = ("n_channels", "max_len", "d_model", "num_layers", "n_head", "dim_feedforward",
              "dropout", "ln_eps", "backbone", "gfp_scale", "attention_impl", "compute_dtype")


def score_model(config: dict, weights: dict, device, num_training_steps: int,
                lr_max: float = 1e-3):
    """The port's model of ``config`` on ``device``, its network holding
    ``weights`` (frozen, as ``init_score_model`` returns it)."""
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model

    m, sde = config["model"], config["sde"]
    cfg = ScoreModelConfig(**{k: m[k] for k in MODEL_KEYS})
    net = init_score_model(cfg, device=device)
    net.load_state_dict(weights)
    scheduler = VPScheduler(fourier_noise_scaling=sde["fourier_noise_scaling"], eps=sde["eps"],
                            beta_min=sde["beta_min"], beta_max=sde["beta_max"])
    return ScoreModel(config=cfg, network=net,
                      scheduler=scheduler.with_noise_scaling(m["max_len"], device),
                      num_training_steps=num_training_steps, lr_max=lr_max)
