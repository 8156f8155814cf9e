"""The DiT backbone of the port (``backbone="dit"``) against the benchmark's
plain reference, ``portbench/reference/dit.py``, on the CPU at a small size
(d_model 48, 2 blocks, 4 heads of 12, 16 tokens, 3 channels), with the
benchmark's seeded weights (``portbench/weights_dit.py``: the adaLN
modulations and the final layer drawn, not zero, so every block acts).

Tolerances: both sides compute in float32 with other orders of the same
sums (the port's fused LayerNorm and GELU, the reference's written out), so
outputs of order 1 agree to a few float32 ulps: rtol 1e-5, atol 1e-5 for a
forward; the loss rtol 1e-5; gradients, sums over 16·3 positions of such
products, rtol 1e-4 with atol 1e-4 of the leaf's largest entry; a 50-step
chain, whose steps add each score times dt to x, rtol 1e-4 and atol 1e-5
(tests/reference's tolerance for the transformer's chain), with the
reference following the chain's decisions only inside its band."""

import math

import pytest
import torch

from fdtpu_torch.diffusion import VPScheduler
from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
from fdtpu_torch.models import score_models as psm
from fdtpu_torch.sampling import DiffusionSampler
from portbench import weights_dit
from portbench.reference import chain, dit
from portbench.reference.model import VP

MODEL = dict(backbone="dit", n_channels=3, max_len=16, d_model=48, num_layers=2, n_head=4,
             dim_feedforward=192, dropout=0.0, ln_eps=1e-6, attention_impl="auto",
             compute_dtype="float32")
SDE = dict(kind="vp", beta_min=0.1, beta_max=20.0, eps=1e-5, fourier_noise_scaling=True)
SCORE = {"level": "score", "R": 8, "tau_0": 0.2, "eps_order": 1}
KV_TAU = 10.0  # the KV event level's calibrated range starts at 1


def _net(seed=3, **overrides):
    m = dict(MODEL, **overrides)
    net = init_score_model(ScoreModelConfig(**m), device="cpu")
    w = weights_dit.make_weights(m, seed, "cpu")
    net.load_state_dict(w)
    return net, w, m


def _model(net, steps=50):
    sched = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(MODEL["max_len"], "cpu")
    return ScoreModel(config=net.config, network=net, scheduler=sched, num_training_steps=steps)


def _xt(batch=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((batch, MODEL["max_len"], MODEL["n_channels"]), generator=g),
            torch.rand((batch,), generator=g))


@pytest.mark.parametrize("impl", ["auto", "blockdiag"])
def test_forward_matches_the_reference(impl):
    """``auto`` is einsum on the CPU; ``blockdiag`` takes B1's layouts (its
    operator's CPU version is the plain attention)."""
    net, w, m = _net(attention_impl=impl)
    assert set(w) == set(net.state_dict())
    assert psm.resolve_attention_impl("auto", 72, "cuda") == "einsum"
    x, t = _xt()
    got = net(x, t)
    want = dit.score(w, m, x, t)
    assert float(want.abs().max()) > 0.5
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_published_zero_init_gives_exactly_zero():
    cfg = ScoreModelConfig(**MODEL)
    net = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    x, t = _xt()
    assert torch.equal(net(x, t), torch.zeros_like(x))
    sd = net.state_dict()
    assert all(not sd[k].any() for k in sd if "modulation" in k or k.startswith("final_layer"))
    assert float(sd["backbone.0.qkv.weight"].abs().max()) > 0.0
    # 18·D² + 15·D a block: the published DiT-XL/2 widths give 674M parameters.
    d = 1152
    per_block = 18 * d * d + 15 * d
    embed = 13 * d + d + 256 * d + d + d * d + d + 2 * d * d + 2 * d + 13 * d + 13
    assert 28 * per_block + embed == 673_656_205


def test_fit_step_loss_and_gradients_match_the_reference(tmp_path, monkeypatch):
    """One ``Trainer.fit`` step (one epoch, one batch): the loss the step
    computed and its gradients against the reference's autograd at the same
    weights, batch, t and z (read from the trainer's generator as
    ``sde_loss`` draws them)."""
    from fdtpu_torch.data import SyntheticDatamodule
    from fdtpu_torch.train import Trainer
    from fdtpu_torch.train import trainer as trainer_mod

    dm = SyntheticDatamodule(tmp_path / "data", max_len=16, num_samples=20, batch_size=32,
                             fourier_transform=True, standardize=True)
    dm.prepare_data()
    dm.setup()
    net, w, m = _net(n_channels=1)
    model = ScoreModel(config=net.config, network=net, scheduler=VPScheduler(
        fourier_noise_scaling=True).with_noise_scaling(16, "cpu"), num_training_steps=1)
    seen, real = [], trainer_mod.sde_loss

    def spy(network, scheduler, x, generator=None, train=True, **kw):
        if train:
            g = torch.Generator().set_state(generator.get_state())
            t = torch.rand((x.shape[0],), generator=g) * (scheduler.T - scheduler.eps) \
                + scheduler.eps
            z = torch.randn(x.shape, generator=g)
        loss = real(network, scheduler, x, generator, train=train, **kw)
        if train:
            names = [n for n, p in network.named_parameters() if p.requires_grad]
            params = [p for p in network.parameters() if p.requires_grad]
            grads = torch.autograd.grad(loss, params, retain_graph=True)
            state = {k: v.detach().clone() for k, v in network.state_dict().items()}
            seen.append((x.clone(), t, z, float(loss.detach()), dict(zip(names, grads)), state))
        return loss

    monkeypatch.setattr(trainer_mod, "sde_loss", spy)
    Trainer(max_epochs=1, run_dir=tmp_path / "runs", run_id="dit", seed=5,
            steps_per_call=1).fit(model, dm)
    assert len(seen) == 1
    x, t, z, loss, grads, state = seen[0]
    ref_w = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    vp = VP(SDE, 16, "cpu")
    mean, std = vp.mean_std(x, t)
    s = dit.score(ref_w, m, mean + std[..., None] * z, t)
    lam = 1.0 / torch.sum(1.0 / std ** 2, dim=1)
    want = (lam[:, None, None] * (s + z / std[..., None]) ** 2).reshape(len(x), -1).mean(-1).mean()
    assert loss == pytest.approx(float(want), rel=1e-5)
    want_grads = torch.autograd.grad(want, [ref_w[k] for k in grads])
    for (name, got), ref in zip(grads.items(), want_grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()),
                                   msg=name)
    assert all(float(g.abs().max()) > 0 for g in want_grads)


@pytest.mark.filterwarnings("ignore:E2-CRF error-budget guard")
@pytest.mark.parametrize("per_call", [1, 2])
def test_score_chain_matches_the_reference_chain(per_call):
    """50 steps, two trajectories of 4 (the eager loop, or the resident
    chain's functions as a CPU loop) against the reference's score level
    around ``reference/dit.py``; both refreshes and skips are taken."""
    net, w, m = _net()
    steps = 50
    sampler = DiffusionSampler(_model(net, steps), 4, use_cache=True, cache_kwargs=SCORE,
                               batches_per_call=per_call)
    g = torch.Generator().manual_seed(1)
    prior = torch.randn((8, 16, 3), generator=g)
    noise = torch.randn((steps, 8, 16, 3), generator=g)
    got = sampler.sample(8, steps, prior_noise=prior, step_noise=noise)
    follow = sampler.last_modes.cpu()
    ref = chain.run_call(lambda x, t: dit.score(w, m, x, t), VP(SDE, 16, "cpu"), prior, noise,
                         4, SCORE, follow, band=1e-3)
    torch.testing.assert_close(got, ref["samples"], rtol=1e-4, atol=1e-5)
    assert ref["mismatched"] == 0 and torch.equal(follow, ref["modes"])
    assert 0 < int(follow.sum()) < follow.numel()


@pytest.mark.filterwarnings("ignore:E2-CRF error-budget guard")
def test_freqca_score_level_runs_and_the_resident_chain_equals_the_eager():
    """FreqCa's score-level predictor works on DiT (it reads only ε̂); the
    KV level's ``use_freqca`` is refused with the KV level."""
    net, _, _ = _net()
    kwargs = dict(SCORE, eps_predictor="freqca")
    out = [DiffusionSampler(_model(net, 40), 4, use_cache=True, cache_kwargs=kwargs,
                            batches_per_call=k) for k in (1, 2)]
    x = [s.sample(8, 40, generator=torch.Generator().manual_seed(2)) for s in out]
    assert torch.equal(x[0], x[1]) and bool(torch.isfinite(x[0]).all())
    modes = out[0].last_modes
    assert 0 < int(modes.sum()) < modes.numel()


@pytest.mark.parametrize("kwargs", [{"level": "token", "token_budget": 4},
                                    {"level": "kv", "policy": "event", "tau_0": KV_TAU},
                                    {"level": "kv", "policy": "event", "tau_0": KV_TAU,
                                     "use_freqca": True}])
def test_token_and_kv_levels_refuse_dit(kwargs):
    net, _, _ = _net()
    sampler = DiffusionSampler(_model(net, 6), 4, use_cache=True, cache_kwargs=kwargs)
    with pytest.raises(ValueError, match="applies to the transformer backbone, not 'dit'"):
        sampler.sample(4, 6, generator=torch.Generator().manual_seed(0))


@pytest.mark.filterwarnings("ignore:E2-CRF error-budget guard")
def test_exported_score_program_equals_the_sampler(tmp_path):
    """Export works on DiT: the reloaded score-level program equals
    ``DiffusionSampler.sample`` bitwise (as tests/test_torch_export.py holds
    the transformer's)."""
    from fdtpu_torch.serve import export_sampler, load_exported

    net, _, _ = _net(d_model=24, n_head=2, dim_feedforward=48)
    sampler = DiffusionSampler(_model(net, 8), 4, use_cache=True,
                               cache_kwargs={"level": "score", "R": 4, "tau_0": 1.0})
    meta = export_sampler(sampler, 8, tmp_path / "dit.pt2")
    assert meta["model"]["backbone"] == "dit"
    got = load_exported(tmp_path / "dit.pt2")(torch.Generator().manual_seed(3))
    want = sampler.sample(4, 8, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, want)
    assert {0, 1} <= set(sampler.last_modes.flatten().tolist())


def test_profiler_ranges_hold_every_block_op_and_vanish_unprofiled():
    """Under ``torch.profiler`` each block opens its three ranges (the
    modulation range three times: before, between and after the two
    sublayers), and no
    operator of a block runs outside them; without the profiler the forward
    opens no range."""
    net, _, _ = _net()
    x, t = _xt()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        net(x, t)
    events = list(prof.events())
    names = [e.name for e in events]
    layers = MODEL["num_layers"]
    assert names.count("fdtpu.dit.attention") == layers
    assert names.count("fdtpu.dit.mlp") == layers
    assert names.count("fdtpu.dit.modulation") == 3 * layers
    ranges = [e for e in events if e.name.startswith("fdtpu.dit.")]
    blocks = ranges[0].time_range.start, ranges[-1].time_range.end
    for op in (e for e in events if e.name in ("aten::addmm", "aten::linear", "aten::layer_norm",
                                               "aten::gelu", "aten::softmax")):
        if blocks[0] <= op.time_range.start <= blocks[1]:
            assert any(r.time_range.start <= op.time_range.start <= r.time_range.end
                       for r in ranges), op.name
    from fdtpu_torch.utils import profiling

    assert profiling.profiler_range("fdtpu.dit.mlp") is profiling._NO_RANGE
    assert math.isfinite(float(net(x, t).sum()))
