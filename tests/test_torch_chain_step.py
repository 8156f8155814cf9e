"""The score chain's step kernels (``fdtpu_torch/kernels/chain_step.py``) on
the CPU: the wrappers refuse CPU tensors (the chain's PyTorch segments run
there), their clock layout and float32 coefficients are the chain's, a CPU
chain keeps its segments, and the states that the card tests hold the
kernels to the segments over (``tests/chain_step_states.py``) reach every
decision of ``pre``: a cold refresh, the calibration step, R expired,
``err_acc`` exactly at τ (τ₀ / overrun with ``auto_calibrate``) and skips.
The kernels themselves run on the card only (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from chain_step_states import load, states
from fdtpu_torch.cache.e2crf import COUNTERS, E2CRFConfig, init_cache_state
from fdtpu_torch.diffusion import VEScheduler, VPScheduler
from fdtpu_torch.kernels import chain_step
from fdtpu_torch.models import ScoreModelConfig, init_score_model
from fdtpu_torch.sampling import DiffusionSampler, resident
from fdtpu_torch.sampling.sampler import no_fresca

B, T, C, STEPS, R = 3, 7, 2, 12, 10
TAU_0 = 0.3
TAU_F32 = float(np.float32(TAU_0))


@pytest.fixture(scope="module")
def network():
    cfg = ScoreModelConfig(n_channels=C, max_len=T, d_model=8, num_layers=1, n_head=2,
                           dim_feedforward=16, dropout=0.0)
    return init_score_model(cfg, torch.Generator().manual_seed(0), "cpu")


def _scheduler(kind):
    sde = (VPScheduler(fourier_noise_scaling=True) if kind == "vp"
           else VEScheduler(fourier_noise_scaling=True))
    return sde.with_noise_scaling(T, "cpu")


def _chain(network, kind="vp", **cache):
    cfg = E2CRFConfig(level="score", R=R, tau_0=TAU_0, **cache)
    return resident.Chain(network, _scheduler(kind), cfg, cfg.policy_params("cpu"),
                          init_cache_state(cfg, B, T, C, "cpu"), B, STEPS, no_fresca, "cpu",
                          resident=True)


@pytest.mark.parametrize("auto_calibrate", [False, True])
def test_the_step_states_reach_every_decision_of_the_pre_segment(network, auto_calibrate):
    """The chain's ``pre`` segment over the card tests' states: the cold
    state takes the cold refresh; the calibration step, R expired and
    ``err_acc`` exactly at τ refresh; the states reach all three branches,
    the skip more than once."""
    chain = _chain(network, auto_calibrate=auto_calibrate)
    tau = TAU_F32 / 2 if auto_calibrate else TAU_F32
    seen = []
    for k, fields in enumerate(states(R, TAU_F32)):
        load(chain, fields, k)
        chain._pre()
        mode, sem = int(chain.mode), int(chain.sem)
        assert int(chain.modes[fields["i"]]) == sem and sem == (mode > 0), fields
        assert int(chain.clock[resident.RUNS + mode]) == (3, 1, 2)[mode] + 1, fields
        seen.append(mode)
        since = fields["step"] - fields["last_full_step"]
        if fields["cold"]:
            assert mode == 2, fields
        elif since >= R or (since == 1 and fields["drift_rate"] == 0.0):
            assert mode == 1, fields
        elif fields["err_acc"] == tau and fields["overrun"] == 2.0:
            assert mode == 1, fields
    assert set(seen) == {0, 1, 2} and seen.count(0) >= 2


@pytest.mark.parametrize("name", ["score_pre", "score_skip", "score_post"])
def test_the_step_kernels_refuse_cpu_tensors(network, name):
    """A CPU chain's tensors: each wrapper raises before it launches."""
    chain = _chain(network)
    c = chain.tensors
    args = {
        "score_pre": (chain.clock, chain.mode, chain.sem, chain.modes, c["drift_rate"],
                      c["err_acc"], chain.pp.tau_0, c["overrun"], R, False),
        "score_skip": (chain.clock, chain.ts, chain.scheduler.G, c["eps_hat"], c["eps_prev"],
                       c["eps_prev2"], c["eps_gap"], c["eps_gap2"], c["drift_rate"],
                       c["err_acc"], chain.score, 1, chain.scheduler),
        "score_post": (chain.clock, chain.sem, chain.ts, chain.step_size, chain.scheduler.G,
                       chain.score, chain.noise, chain.x, torch.zeros((), dtype=torch.int32),
                       chain.scheduler, T)}[name]
    counter = f"launches_{name.split('_')[1]}"
    before = getattr(chain_step, counter)
    with pytest.raises(ValueError, match="runs on a CUDA device"):
        getattr(chain_step, name)(*args)
    assert getattr(chain_step, counter) == before


def test_coefficients_are_the_float32_scalars_of_the_composition():
    vp, ve = VPScheduler(beta_min=0.1, beta_max=20.0), VEScheduler(sigma_min=0.01,
                                                                   sigma_max=50.0)
    assert chain_step.std_coefficients(vp) == (0, float(np.float32(0.1)),
                                               float(np.float32(20.0 - 0.1)))
    assert chain_step.step_coefficients(vp) == chain_step.std_coefficients(vp)
    assert chain_step.std_coefficients(ve)[1:] == (float(np.float32(0.01)), 5000.0)
    assert chain_step.step_coefficients(ve)[1] == float(np.float32(
        0.01 * np.sqrt(2.0 * np.log(50.0 / 0.01))))


@pytest.mark.parametrize("options", [dict(eps_predictor="taylor"),
                                     dict(eps_predictor="freqca", max_history=4)])
def test_a_cpu_chain_runs_its_pytorch_segments(network, options):
    """On the CPU the chain keeps its PyTorch segments at every predictor,
    so the kernels' wrappers are never called: nothing launched."""
    from fdtpu_torch.models import ScoreModel

    model = ScoreModel(config=network.config, network=network, scheduler=_scheduler("vp"))
    sampler = DiffusionSampler(model, B, use_cache=True,
                               cache_kwargs=dict(level="score", R=4, tau_0=0.5, **options),
                               batches_per_call=2)
    before = (chain_step.launches_pre, chain_step.launches_skip, chain_step.launches_post)
    sampler.sample(2 * B, 6, generator=torch.Generator().manual_seed(1))
    (chain,) = sampler._chains.values()
    assert not chain.step_kernels
    assert (chain_step.launches_pre, chain_step.launches_skip,
            chain_step.launches_post) == before


def test_the_kernels_clock_layout_is_the_chains():
    """``csrc/chain_step.cu`` indexes the chain's clock by position: the
    wrapper's positions are the chain's (its counters in ``COUNTERS`` order
    after the step index, then the branches' runs)."""
    assert chain_step.I == 0 and chain_step.RUNS == resident.RUNS
    positions = (chain_step.STEP, chain_step.LAST_FULL, chain_step.COLD, chain_step.RECOMPUTE,
                 chain_step.HITS, chain_step.FULL, chain_step.MIXED, chain_step.CACHED)
    assert tuple(COUNTERS[p - 1] for p in positions) == (
        "step", "last_full_step", "cold", "recompute_count", "cache_hit_count", "full_steps",
        "mixed_steps", "cached_steps")
