"""The port's exported sampling program against the JAX package's
(``fdtpu.serve``), and the export CLI.

The same model in both packages (the JAX variables carried over with
``load_jax_variables``), at tests/test_serve.py's sizes: ``fdtpu.serve``'s
program called with a JAX key against the port's ``fn.program`` fed that
key's draws (``split(key, 3)``: the prior from the second key, each step's
noise from the third as the JAX chain splits it), uncached and at the score
level, at tests/test_serve.py's own tolerance (atol 5e-5, rtol 1e-5: XLA's
CPU backend contracts the time grid's ``1 - s`` into a fused multiply-add,
ROADMAP.md §C).  Then ``python -m fdtpu_torch.cli.export_sampler`` on a tiny
trained run (``+device=cpu``), its program loaded and held to the sampler
built from the same checkpoint.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cli import _train_args
from test_torch_export import B, C, L, SCORE, STEPS, tiny_model

from fdtpu.diffusion import VPScheduler as JaxVP
from fdtpu.models import ScoreModelConfig as JaxScoreModelConfig
from fdtpu.models import init_score_model as jax_init_score_model
from fdtpu.models.score_models import ScoreModel as JaxScoreModel
from fdtpu.sampling import DiffusionSampler as JaxDiffusionSampler
from fdtpu.serve import export_sampler as jax_export_sampler
from fdtpu.serve import load_exported as jax_load_exported
from fdtpu_torch.cli import export_sampler as export_cli
from fdtpu_torch.cli import train as train_cli
from fdtpu_torch.sampling import DiffusionSampler
from fdtpu_torch.serve import export_sampler, load_exported
from fdtpu_torch.train import get_best_checkpoint, load_checkpoint
from fdtpu_torch.utils.convert import load_jax_variables


@pytest.fixture(scope="module")
def models():
    jcfg = JaxScoreModelConfig(n_channels=C, max_len=L, d_model=12, num_layers=2, n_head=2,
                               dim_feedforward=24)
    variables = jax_init_score_model(jax.random.PRNGKey(0), jcfg)
    jmodel = JaxScoreModel(config=jcfg, variables=variables,
                           scheduler=JaxVP(fourier_noise_scaling=True).with_noise_scaling(L))
    model = tiny_model()
    load_jax_variables(model.network, jax.tree.map(np.asarray, variables))
    return jmodel, model


def jax_draws(key, steps):
    """The draws of the JAX program's first batch at ``key``."""
    _, k_prior, k_chain = jax.random.split(key, 3)
    prior = np.array(jax.random.normal(k_prior, (B, L, C), jnp.float32))
    zs = []
    for _ in range(steps):
        k_chain, k_noise = jax.random.split(k_chain)
        zs.append(np.array(jax.random.normal(k_noise, (B, L, C), jnp.float32)))
    return torch.from_numpy(prior), torch.from_numpy(np.stack(zs))


@pytest.mark.parametrize("cache_kwargs", [None, SCORE], ids=["uncached", "score"])
def test_port_program_matches_the_jax_program(models, tmp_path, cache_kwargs):
    jmodel, model = models
    use_cache = cache_kwargs is not None
    jax_sampler = JaxDiffusionSampler(jmodel, sample_batch_size=B, use_cache=use_cache,
                                      cache_kwargs=cache_kwargs)
    jax_export_sampler(jax_sampler, num_diffusion_steps=STEPS, path=tmp_path / "jax.stablehlo")
    sampler = DiffusionSampler(model, sample_batch_size=B, use_cache=use_cache,
                               cache_kwargs=cache_kwargs)
    export_sampler(sampler, STEPS, tmp_path / "port.pt2")
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_load_exported(tmp_path / "jax.stablehlo")(key))
    got = load_exported(tmp_path / "port.pt2").program(*jax_draws(key, STEPS))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    return train_cli.main(_train_args(tmp_path_factory.mktemp("export_cli"))).trainer.run_dir


@pytest.mark.filterwarnings("ignore:E2-CRF error-budget guard")
@pytest.mark.parametrize("extra", [[], ["use_cache=true", "+cache_kwargs.level=score",
                                        "+cache_kwargs.R=3"]], ids=["uncached", "score"])
def test_export_cli_writes_a_program_the_loader_runs(trained_run, capsys, extra):
    args = [f"model_path={trained_run.parent}", f"model_id={trained_run.name}",
            "sample_batch_size=4", "num_diffusion_steps=6", "+device=cpu", *extra]
    line = export_cli.main(args)
    out = Path(line["path"])
    assert out == trained_run / "export" / "sampler.pt2"
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert line["sample_batch_size"] == 4 and line["num_diffusion_steps"] == 6
    assert line["use_cache"] == bool(extra)
    assert json.loads(Path(f"{out}.json").read_text()) == {k: v for k, v in line.items()
                                                          if k != "path"}
    got = load_exported(out)(torch.Generator().manual_seed(0))
    model = load_checkpoint(get_best_checkpoint(trained_run / "checkpoints"), device="cpu")
    sampler = DiffusionSampler(model, 4, use_cache=bool(extra),
                               cache_kwargs={"level": "score", "R": 3} if extra else None)
    want = sampler.sample(4, 6, generator=torch.Generator().manual_seed(0))
    assert got.shape == (4, 20, 1) and torch.equal(got, want)
