"""FreqCa in the exported sampling program (``fdtpu_torch.serve``) on the CPU,
at tests/test_torch_export.py's sizes (d_model 12, 2 layers, 2 heads, 16
tokens, 2 channels, batches of 4, 8 steps).

The score level's ``eps_predictor="freqca"`` (a ring of ε̂'s high-frequency
parts, Hermite-extrapolated on skipped steps) and the KV level's
``use_freqca`` ring (the CRF's parts, an entry every ``freq_decomp_interval``
steps) are exported, reloaded and held to ``DiffusionSampler.sample``
bitwise, with the same generator; the score level's Hermite fit goes
through the registered ``fdtpu::hermite_solve`` in both
(``fdtpu_torch/kernels/solve.py``, opchecked here).  Then the programs against ``fdtpu.serve``'s program on the
JAX key's draws at tests/test_torch_export_jax.py's tolerance (atol 5e-5,
rtol 1e-5: XLA's CPU backend contracts the time grid's ``1 - s`` into a
fused multiply-add, so FreqCa's ring timesteps may differ by one float32 ulp,
ROADMAP.md §C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_export import B, C, L, STEPS, tiny_model

from fdtpu.diffusion import VPScheduler as JaxVP
from fdtpu.models import ScoreModelConfig as JaxScoreModelConfig
from fdtpu.models import init_score_model as jax_init_score_model
from fdtpu.models.score_models import ScoreModel as JaxScoreModel
from fdtpu.sampling import DiffusionSampler as JaxDiffusionSampler
from fdtpu.serve import export_sampler as jax_export_sampler
from fdtpu.serve import load_exported as jax_load_exported
from fdtpu_torch.kernels import solve
from fdtpu_torch.sampling import DiffusionSampler
from fdtpu_torch.serve import export_sampler, load_exported
from fdtpu_torch.utils.convert import load_jax_variables

FREQCA = {
    "score-freqca": {"level": "score", "R": 4, "tau_0": 1.0, "eps_predictor": "freqca",
                     "max_history": 4, "hermite_order": 2, "guard": "off"},
    "kv-freqca": {"level": "kv", "policy": "event", "tau_0": 10.0, "K": 2, "R": 4,
                  "use_freqca": True, "freq_decomp_interval": 2, "max_history": 3},
}


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


@pytest.fixture(scope="module")
def exported(models, tmp_path_factory):
    """Each FreqCa chain exported and reloaded once: name -> (sampler, fn)."""
    root = tmp_path_factory.mktemp("export_freqca")
    out = {}
    for name, kw in FREQCA.items():
        sampler = DiffusionSampler(models[1], sample_batch_size=B, use_cache=True,
                                   cache_kwargs=kw)
        export_sampler(sampler, STEPS, root / f"{name}.pt2")
        out[name] = (sampler, load_exported(root / f"{name}.pt2"))
    return out


@pytest.mark.parametrize("name", list(FREQCA))
def test_freqca_program_equals_the_sampler_bitwise(exported, name):
    sampler, fn = exported[name]
    got = fn(torch.Generator().manual_seed(3))
    want = sampler.sample(B, STEPS, generator=torch.Generator().manual_seed(3))
    assert got.shape == (B, L, C)
    assert torch.equal(got, want), f"max diff {float((got - want).abs().max()):.3g}"
    state = sampler.last_cache_state
    if name == "score-freqca":
        # Skipped steps predicted from a ring of at least two refreshes.
        assert set(sampler.last_modes.flatten().tolist()) == {0, 1}
        assert int(state.hist_len) >= 2
    else:
        # The ring took an entry every second step.
        assert int(state.hist_len) == 3


@pytest.mark.parametrize("name", list(FREQCA))
def test_freqca_program_calls_the_solve_operator(exported, name):
    """The score level's skip branch solves through the operator (the KV
    level's ring is filled, never extrapolated, as in the JAX package: quirk
    Q1), and no program calls torch's solve directly."""
    targets = set()
    for module in exported[name][1].program.modules():
        if isinstance(module, torch.fx.GraphModule):
            targets |= {str(n.target) for n in module.graph.nodes if n.op == "call_function"}
    assert ("fdtpu.hermite_solve.default" in targets) == (name == "score-freqca"), sorted(targets)
    assert not any("linalg_solve" in t for t in targets)


def test_hermite_solve_operator_passes_opcheck():
    g = torch.Generator().manual_seed(0)
    a = torch.randn((3, 3), generator=g) + 3 * torch.eye(3)
    b = torch.randn((3, 20), generator=g)
    torch.library.opcheck(torch.ops.fdtpu.hermite_solve.default, (a, b))
    assert torch.equal(solve.hermite_solve(a, b), torch.linalg.solve_ex(a, b).result)


def _jax_draws(key, steps):
    """The JAX program's first batch's draws at ``key``: the prior from the
    second of ``split(key, 3)``, then each step's noise (the score level
    splits a step's key two ways, the KV level three)."""
    _, k_prior, k_chain = jax.random.split(key, 3)
    prior = np.array(jax.random.normal(k_prior, (B, L, C), jnp.float32))
    return prior, k_chain


@pytest.mark.parametrize("name", list(FREQCA))
def test_freqca_program_matches_the_jax_program(models, exported, tmp_path, name):
    jmodel, _ = models
    kw = FREQCA[name]
    jax_sampler = JaxDiffusionSampler(jmodel, sample_batch_size=B, use_cache=True,
                                      cache_kwargs=kw)
    jax_export_sampler(jax_sampler, num_diffusion_steps=STEPS, path=tmp_path / "jax.stablehlo")
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_load_exported(tmp_path / "jax.stablehlo")(key))
    prior, k_chain = _jax_draws(key, STEPS)
    zs = []
    for _ in range(STEPS):
        if kw["level"] == "score":
            k_chain, k_noise = jax.random.split(k_chain)
        else:
            k_chain, k_noise, _ = jax.random.split(k_chain, 3)
        zs.append(np.array(jax.random.normal(k_noise, (B, L, C), jnp.float32)))
    got = exported[name][1].program(torch.from_numpy(prior), torch.from_numpy(np.stack(zs)))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-5)
