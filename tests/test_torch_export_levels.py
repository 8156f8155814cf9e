"""Export of the sampling program at the levels tests/test_torch_export.py
leaves out, at its sizes: the score level at ``eps_order`` 0 with the guard
off, and the KV level's event policy (with random probes, so the program
takes the probe uniforms) and macro policy.  The reloaded program against
``DiffusionSampler.sample`` with the same generator, bitwise; each chain
takes more than one of its modes."""

import pytest
import torch
from test_torch_export import B, SCORE, STEPS, make_sampler

from fdtpu_torch.serve import export_sampler, load_exported

CHAINS = {
    "score-order0-guard-off": (dict(SCORE, eps_order=0, guard="off"), {}),
    "kv-event-probes": ({"level": "kv", "policy": "event", "K": 2, "R": 4, "tau_0": 10.0,
                         "random_probe_ratio": 0.2}, {}),
    # The macro policy refreshes every step % R == 0 at R >= 100 (else 500):
    # within 8 steps, FULL then CACHED.
    "kv-macro": ({"level": "kv", "policy": "macro", "K": 2, "R": 100}, {}),
}
# The modes each chain must take: (refresh, skip), (FULL, MIXED), (FULL, CACHED).
MODES = {"score-order0-guard-off": {0, 1}, "kv-event-probes": {0, 1}, "kv-macro": {0, 2}}


@pytest.mark.parametrize("name", list(CHAINS))
def test_reloaded_program_equals_the_sampler_bitwise(tmp_path, name):
    sampler = make_sampler(name, chains=CHAINS)
    meta = export_sampler(sampler, STEPS, tmp_path / "p.pt2")
    assert ("probe_noise" in meta["input"]) == (name == "kv-event-probes")
    got = load_exported(tmp_path / "p.pt2")(torch.Generator().manual_seed(3))
    want = sampler.sample(B, STEPS, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, want), f"max diff {float((got - want).abs().max()):.3g}"
    assert MODES[name] <= set(sampler.last_modes.flatten().tolist())
