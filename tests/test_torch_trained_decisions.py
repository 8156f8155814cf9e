"""The token level's decisions on trained weights, fdtpu_torch against fdtpu.

A small transformer is trained with the JAX trainer on synthetic
frequency-domain data (960 steps: the validation loss falls about fivefold),
its weights are carried into the port with ``load_jax_variables``, and the
``token_full`` arm of ``cli/ablation_cache.py`` (``{"level": "token",
"token_budget": 24, "tau_0": 0.5, "R": 100}``) runs 100 steps in both
packages, the JAX chain's own noise and probe uniforms handed to the port.
The step modes and the rows each TOPK step recomputes must be equal at every
step (the first step that differs is reported), the samples within 5e-4
(the token chain's tolerance on the card: the VP std's cancellation at the
last step); the same arm on the random initial weights is the control.  On
these trained weights both packages skip 2 of the 100 steps, against 38 on
the random ones: trained weights rarely let the token level skip, in the
reference as in the port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.cache import e2crf as je
from fdtpu.data import SyntheticDatamodule
from fdtpu.diffusion import VPScheduler as JaxVP
from fdtpu.models import ScoreModelConfig, init_score_model
from fdtpu.models.score_models import ScoreModel
from fdtpu.sampling import sampler as jsampler
from fdtpu.train import Trainer, get_training_params
from fdtpu_torch.cache import e2crf as pe
from fdtpu_torch.diffusion import VPScheduler
from fdtpu_torch.models import score_models as psm
from fdtpu_torch.sampling import sampler as psampler
from fdtpu_torch.utils.convert import load_jax_variables
from test_torch_token_kv import recorded_steps

T, C, B = 32, 1, 4
SHAPE = dict(n_channels=C, max_len=T, d_model=24, num_layers=2, n_head=4, dim_feedforward=48)
EPOCHS = 120  # 8 steps an epoch
STEPS = 100
TOKEN_FULL = {"level": "token", "token_budget": 24, "tau_0": 0.5, "R": 100}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    dm = SyntheticDatamodule(data_dir=tmp_path_factory.mktemp("data"), max_len=T,
                             num_samples=512, batch_size=64, fourier_transform=True,
                             standardize=True)
    dm.prepare_data()
    dm.setup()
    cfg = ScoreModelConfig(**SHAPE)
    scheduler = JaxVP(fourier_noise_scaling=True).with_noise_scaling(T)
    model = ScoreModel(config=cfg, variables=init_score_model(jax.random.PRNGKey(0), cfg),
                       scheduler=scheduler, lr_max=1e-3,
                       num_training_steps=get_training_params(dm, EPOCHS)["num_training_steps"])
    initial = jax.tree.map(np.array, model.variables)
    trainer = Trainer(max_epochs=EPOCHS, run_dir=tmp_path_factory.mktemp("runs"), seed=42)
    model = trainer.fit(model, dm)
    val = [json.loads(line)["val/loss"] for line in open(trainer.metrics_path)
           if "val/loss" in line]
    return cfg, scheduler, {"random": initial,
                            "trained": jax.tree.map(np.array, model.variables)}, val


def _chain(cfg, scheduler, variables):
    """The token_full chain in both packages on the same weights and draws:
    (JAX modes, port modes, record, JAX samples, port samples)."""
    net = psm.init_score_model(psm.ScoreModelConfig(**SHAPE), device="cpu")
    load_jax_variables(net, variables)
    x0 = np.array(scheduler.prior_sampling(jax.random.PRNGKey(6), (B, T, C)))
    key = jax.random.PRNGKey(8)
    zs, us, k = [], [], key
    for _ in range(STEPS):
        k, k_noise, k_probe = jax.random.split(k, 3)
        zs.append(np.array(jax.random.normal(k_noise, (B, T, C), jnp.float32)))
        us.append(np.array(jax.random.uniform(k_probe, (T,))))
    jcc = je.E2CRFConfig(**TOKEN_FULL)
    state = je.init_cache_state(jcc, cfg.num_layers, B, cfg.n_head, T, cfg.head_dim,
                                cfg.d_model, C)
    ps = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(T, "cpu")
    with recorded_steps(TOKEN_FULL) as rec:
        want, _ = jsampler.sample_chain(jax.tree.map(jnp.asarray, variables), scheduler,
                                        jnp.asarray(x0), key, state, model_cfg=cfg,
                                        cache_cfg=jcc, num_steps=STEPS)
        got, _ = psampler.sample_chain(net, ps, torch.from_numpy(x0),
                                       cache_cfg=pe.E2CRFConfig(**TOKEN_FULL), num_steps=STEPS,
                                       step_noise=torch.from_numpy(np.stack(zs)),
                                       probe_noise=torch.from_numpy(np.stack(us)))
    return rec, np.asarray(want), got.numpy()


def test_training_left_the_random_weights(trained):
    *_, val = trained
    assert len(val) == EPOCHS
    assert min(val) < val[0] / 3, val


@pytest.fixture(scope="module")
def chains(trained):
    cfg, scheduler, variables, _ = trained
    return {weights: _chain(cfg, scheduler, v) for weights, v in variables.items()}


@pytest.mark.parametrize("weights", ["random", "trained"])
def test_token_full_modes_match_jax_at_every_step(chains, weights):
    rec, want, got = chains[weights]
    jm, pm = rec["jmode"], rec["pmode"]
    assert len(jm) == len(pm) == STEPS
    diverged = [i for i, (a, b) in enumerate(zip(jm, pm)) if a != b]
    assert not diverged, f"modes diverge first at step {diverged[0]}: jax {jm} port {pm}"
    assert rec["prows"] == rec["jrows"]
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_trained_weights_rarely_skip_in_both_packages(chains):
    skips = {weights: (rec["jmode"].count(pe.TOKEN_SKIP), rec["pmode"].count(pe.TOKEN_SKIP))
             for weights, (rec, *_) in chains.items()}
    assert skips["trained"][0] == skips["trained"][1]
    assert skips["trained"][0] <= STEPS // 10 < skips["random"][0], skips
