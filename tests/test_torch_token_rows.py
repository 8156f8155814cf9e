"""The token level's record of the rows each TOPK step took
(``DiffusionSampler.last_rows``), on the CPU: the rows recorded are the rows
the chain's TOPK steps computed (read where the step picks them,
``_topk_rows``), −1 at every other step, the same in the eager loop and the
resident chain's functions; the samples and modes are bitwise those of a
chain that records nothing; and there are none off the token level."""

import pytest
import torch

from fdtpu_torch.cache.e2crf import TOKEN_TOPK
from fdtpu_torch.diffusion import VPScheduler
from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
from fdtpu_torch.sampling import DiffusionSampler
from fdtpu_torch.sampling import resident
from fdtpu_torch.sampling import sampler as sampler_mod

T, BUDGET, STEPS = 20, 6, 40
TOKEN = {"level": "token", "token_budget": BUDGET, "tau_0": 0.05, "R": 10}


def _model():
    cfg = ScoreModelConfig(n_channels=2, max_len=T, d_model=12, num_layers=2, n_head=3,
                           dim_feedforward=24)
    net = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    sched = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(T, "cpu")
    return ScoreModel(config=cfg, network=net, scheduler=sched)


@pytest.mark.filterwarnings("ignore:E2-CRF error-budget guard")
@pytest.mark.parametrize("per_call", [1, 2])
def test_recorded_rows_are_the_rows_the_chain_took(monkeypatch, per_call):
    model = _model()
    taken, real = [], sampler_mod._topk_rows

    def spy(priority, budget):
        idx = real(priority, budget)
        taken.append(idx.clone())
        return idx

    def sample():
        sampler = DiffusionSampler(model, 4, use_cache=True, cache_kwargs=TOKEN,
                                   batches_per_call=per_call)
        return sampler, sampler.sample(8, STEPS, generator=torch.Generator().manual_seed(3))

    with monkeypatch.context() as m:
        m.setattr(resident.Chain, "_record_rows", lambda self, idx: None)
        plain, want = sample()
    assert bool((plain.last_rows == -1).all())
    monkeypatch.setattr(sampler_mod, "_topk_rows", spy)
    recorder, got = sample()
    assert torch.equal(got, want) and torch.equal(recorder.last_modes, plain.last_modes)
    rows, modes = recorder.last_rows, recorder.last_modes
    assert rows.shape == (2, STEPS, BUDGET) and rows.dtype == torch.int64
    topk = modes == TOKEN_TOPK
    assert 0 < int(topk.sum()) == len(taken)
    assert torch.equal(rows[topk], torch.stack(taken))
    assert bool((rows[~topk] == -1).all())


@pytest.mark.parametrize("cache_kwargs", [None, {"level": "score"}])
def test_no_rows_off_the_token_level(cache_kwargs):
    sampler = DiffusionSampler(_model(), 4, use_cache=cache_kwargs is not None,
                               cache_kwargs=cache_kwargs)
    sampler.sample(4, 8, generator=torch.Generator().manual_seed(3))
    assert sampler.last_rows is None
