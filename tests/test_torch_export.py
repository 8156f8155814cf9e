"""Export of the sampling program (``fdtpu_torch.serve``) on the CPU, at the
sizes of tests/test_serve.py (d_model 12, 2 layers, 2 heads, 16 tokens, 2
channels, batches of 4, 8 steps), the attention through the registered
``fdtpu::`` operators (``attention_impl="blockdiag"``: their CPU
implementations are the plain versions).

The exported and reloaded program against ``DiffusionSampler.sample`` with
the same generator: bitwise at every exported level, since both run the same
functions on the same draws (the loader draws them in the sampler's order).
The score and token levels' chains must take both kinds of step.  Then the
program's structure: one ``while_loop`` (the same graph at 8 and 64 steps),
every layer's FFN tail through ``fdtpu::ffn_block``,
the JAX meta's keys, FreqCa's programs run untraced, and a loader that
imports no model, sampler, cache or training code and no JAX.  More levels
are in tests/test_torch_export_levels.py, the JAX comparison and the CLI in
tests/test_torch_export_jax.py.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fdtpu_torch.diffusion import VPScheduler
from fdtpu_torch.kernels import attention as mha
from fdtpu_torch.kernels import blockdiag_attention as bda
from fdtpu_torch.kernels import ffn
from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
from fdtpu_torch.sampling import DiffusionSampler
from fdtpu_torch.serve import export_sampler, load_exported, make_sampling_fn

REPO = Path(__file__).resolve().parents[1]
L, C, B, STEPS = 16, 2, 4, 8
# The JAX exporter's meta keys (fdtpu/serve/export.py:103-136).
JAX_META = {"format", "calling_convention", "platforms", "input", "output",
            "num_diffusion_steps", "sample_batch_size", "model", "use_cache", "cache_kwargs"}
SCORE = {"level": "score", "R": 4, "tau_0": 1.0}
CHAINS = {
    "uncached": (None, {}),
    "score-order1-guard": (dict(SCORE, eps_order=1), {}),
    "score-fresca": (SCORE, {"use_fresca": True}),
    # token_full's R and tau_0 (cli/ablation_cache.py:60), a budget of 16 tokens' share.
    "token-full": ({"level": "token", "token_budget": 4, "tau_0": 0.5, "R": 100}, {}),
}


def tiny_model(attention_impl="blockdiag"):
    cfg = ScoreModelConfig(n_channels=C, max_len=L, d_model=12, num_layers=2, n_head=2,
                           dim_feedforward=24, attention_impl=attention_impl)
    net = init_score_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    sched = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(L, "cpu")
    return ScoreModel(config=cfg, network=net, scheduler=sched)


def make_sampler(name, model=None, chains=CHAINS):
    kwargs, options = chains[name]
    return DiffusionSampler(model or tiny_model(), sample_batch_size=B,
                            use_cache=kwargs is not None, cache_kwargs=kwargs, **options)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Each chain exported once, on demand: name -> (sampler, path, meta)."""
    root = tmp_path_factory.mktemp("export")
    done = {}

    def get(name):
        if name not in done:
            sampler = make_sampler(name)
            path = root / f"{name}.pt2"
            done[name] = (sampler, path, export_sampler(sampler, STEPS, path))
        return done[name]

    return get


@pytest.mark.filterwarnings("ignore:E2-CRF error-budget guard")
@pytest.mark.parametrize("name", list(CHAINS))
def test_reloaded_program_equals_the_sampler_bitwise(exported, name):
    sampler, path, meta = exported(name)
    fn = load_exported(path)
    got = fn(torch.Generator().manual_seed(3))
    want = sampler.sample(B, STEPS, generator=torch.Generator().manual_seed(3))
    assert got.shape == (B, L, C) and got.dtype == torch.float32
    assert torch.equal(got, want), f"max diff {float((got - want).abs().max()):.3g}"
    if sampler.use_cache:
        # Both kinds of step ran: a refresh and a skip (score level), FULL
        # and TOPK (token level).
        modes = set(sampler.last_modes.flatten().tolist())
        assert {0, 1} <= modes, modes
    # A second generator: the program is not tied to its example draws.
    other = fn(torch.Generator().manual_seed(4))
    assert torch.isfinite(other).all() and not torch.equal(other, got)


@pytest.mark.filterwarnings("ignore:E2-CRF error-budget guard")
def test_the_program_takes_injected_draws_as_the_sampler_does(exported):
    sampler, path, _ = exported("token-full")
    g = torch.Generator().manual_seed(9)
    prior = torch.randn((B, L, C), generator=g)
    steps = torch.randn((STEPS, B, L, C), generator=g)
    probes = torch.rand((STEPS, L), generator=g)
    got = load_exported(path).program(prior, steps, probes)
    want = sampler.sample(B, STEPS, prior_noise=prior, step_noise=steps,
                          probe_noise=probes[None])
    assert torch.equal(got, want)


def test_the_program_launches_no_kernel_on_the_cpu(exported):
    _, path, _ = exported("uncached")
    before = (bda.launches, mha.launches)
    load_exported(path)(torch.Generator().manual_seed(0))
    assert (bda.launches, mha.launches) == before


def test_every_forward_of_the_program_reaches_the_ffn_operator(exported):
    """The exported graph runs each layer's FFN tail through
    ``fdtpu::ffn_block`` (traced through its fake implementation), in the
    token level's FULL and TOPK forwards alike, and on the CPU the reloaded
    program launches no F1 kernel."""
    _, path, _ = exported("token-full")
    calls = []

    def walk(module):
        calls.extend(n for n in module.graph.nodes
                     if str(n.target) == "fdtpu.ffn_block.default")
        for child in module.children():
            if isinstance(child, torch.fx.GraphModule):
                walk(child)

    walk(torch.export.load(path).module())
    layers = tiny_model().config.num_layers
    assert len(calls) >= 2 * layers and len(calls) % layers == 0
    before = ffn.launches
    load_exported(path)(torch.Generator().manual_seed(0))
    assert ffn.launches == before


def test_meta_has_the_jax_keys_and_the_draws(exported):
    sampler, path, meta = exported("token-full")
    assert JAX_META <= set(meta)
    assert json.loads(Path(f"{path}.json").read_text()) == meta
    assert meta["format"] == "torch.export/pt2"
    assert meta["calling_convention"] == f"torch {torch.__version__}"
    assert meta["platforms"] == ["cpu"]
    assert meta["input"] == {"prior_noise": f"float32[{B}, {L}, {C}]",
                             "step_noise": f"float32[{STEPS}, {B}, {L}, {C}]",
                             "probe_noise": f"float32[{STEPS}, {L}]"}
    assert meta["output"] == {"samples": f"float32[{B}, {L}, {C}]"}
    assert meta["cache_kwargs"] == {"level": "token", "policy": "event", "R": 100, "tau_0": 0.5}
    assert [(d["name"], d["per_step"]) for d in meta["draws"]] == [
        ("prior_noise", False), ("probe_noise", True), ("step_noise", True)]
    assert exported("uncached")[2]["cache_kwargs"] is None
    assert "probe_noise" not in exported("uncached")[2]["input"]


def test_graph_does_not_grow_with_the_step_count(tmp_path):
    sampler = make_sampler("uncached")
    counts = []
    for steps in (STEPS, 64):
        export_sampler(sampler, steps, tmp_path / f"{steps}.pt2")
        graph = torch.export.load(tmp_path / f"{steps}.pt2").graph
        counts.append(len(graph.nodes))
        assert any("while_loop" in str(n.target) for n in graph.nodes)
    assert counts[0] == counts[1]


@pytest.mark.parametrize("kwargs", [
    dict(SCORE, eps_predictor="freqca"),
    {"level": "kv", "policy": "event", "tau_0": 10.0, "use_freqca": True},
], ids=["score-freqca", "kv-freqca-ring"])
def test_a_level_not_exported_yet_raises(tmp_path, kwargs):
    """FreqCa was the last level the exporter refused; its program (run
    here eagerly, untraced) now gives the sampler's samples bitwise on the
    same draws.  The traced programs are in tests/test_torch_export_freqca.py."""
    sampler = DiffusionSampler(tiny_model(), B, use_cache=True, cache_kwargs=kwargs)
    program = make_sampling_fn(sampler, STEPS)
    # An eager while_loop compiles its body; the other case's program left
    # entries whose shapes dynamo would now mark dynamic.
    torch._dynamo.reset()
    g = torch.Generator().manual_seed(5)
    draws = [torch.randn(shape, generator=g) for shape in program.input_shapes().values()]
    with torch.no_grad():
        got = program(*draws)
    want = sampler.sample(B, STEPS, prior_noise=draws[0], step_noise=draws[1])
    assert torch.equal(got, want)
    assert not (tmp_path / "p.pt2").exists()


def test_platforms_other_than_the_samplers_device_raise(tmp_path):
    with pytest.raises(ValueError, match="runs where it was exported"):
        export_sampler(make_sampler("uncached"), STEPS, tmp_path / "p.pt2", platforms=["cuda"])


def test_the_loader_imports_only_the_kernels_of_the_port(exported):
    _, path, _ = exported("score-order1-guard")
    code = (
        "import json, sys, torch\n"
        "from fdtpu_torch.serve import load_exported\n"
        f"fn = load_exported({str(path)!r})\n"
        "x = fn(torch.Generator().manual_seed(0))\n"
        "assert x.shape == (4, 16, 2) and bool(torch.isfinite(x).all())\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=path.parent, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    modules = set(json.loads(proc.stdout.splitlines()[-1]))
    port = {m for m in modules if m.startswith("fdtpu_torch.")}
    assert "fdtpu_torch.kernels.blockdiag_attention" in port
    for forbidden in ("models", "sampling", "cache", "train", "utils", "diffusion", "ops"):
        assert not {m for m in port if m.startswith(f"fdtpu_torch.{forbidden}")}, forbidden
    assert not {m for m in modules if m.split(".")[0] in ("jax", "jaxlib", "fdtpu")}


def _mha_args():
    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 16, 12), generator=g)
    k = torch.randn((2, 2, 6, 16), generator=g)
    v = torch.randn((2, 2, 16, 6), generator=g)
    return q, k, v


@pytest.mark.parametrize("op", ["blockdiag_mha", "blockdiag_mha_bwd", "fused_mha"])
def test_registered_operators_pass_opcheck(op):
    q, k, v = _mha_args()
    args = {
        "blockdiag_mha": (q, k, v, True),
        "blockdiag_mha_bwd": (q, k, v, torch.randn_like(q)),
        # The token level's TOPK shape: 4 query rows against all 16 keys.
        "fused_mha": (q.reshape(2, 16, 2, 6)[:, :4].contiguous(),
                      k.permute(0, 3, 1, 2).contiguous(), v.permute(0, 2, 1, 3).contiguous()),
    }[op]
    torch.library.opcheck(getattr(torch.ops.fdtpu, op).default, args)


def test_the_model_reaches_the_kernels_through_the_operators(exported):
    """The exported graph calls the fdtpu:: operators: B1 in every full
    forward, B4 in the token level's TOPK forward."""
    _, path, _ = exported("token-full")
    targets = set()

    def walk(module):
        for node in module.graph.nodes:
            targets.add(str(node.target))
        for child in module.children():
            if isinstance(child, torch.fx.GraphModule):
                walk(child)

    walk(torch.export.load(path).module())
    assert {"fdtpu.blockdiag_mha.default", "fdtpu.fused_mha.default"} <= targets
