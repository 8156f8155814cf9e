"""Distribution of the port (``fdtpu_torch.dist``, ``DiffusionSampler(mesh=)``,
``Trainer(mesh=)``) on the CPU, against the JAX package's ``fdtpu.dist``.

The mesh's helpers are held to ``fdtpu.dist``'s results: ``MeshConfig.resolve``
and its error, ``pad_to_multiple``, and ``tp_param_spec``, whose placement of
the in-projection is per head where the JAX spec's is contiguous (the values
a rank holds are checked against the JAX weights).

The mesh runs are gloo processes spawned from the test
(``tests/torch_dist_workers.py``, a ``file://`` store under ``tmp_path``); the
JAX references run here, on conftest's 8 virtual CPU devices.

* Sampler: 2 and 4 ranks, every level (uncached, score, token, KV event with
  FreqCa's ring; the score level with FreSca and with FreqCa; the resident
  chain at the score, token and KV levels), against the port's single-process
  sampler, and at the uncached, score, token and KV levels against
  ``fdtpu``'s ``DiffusionSampler(mesh=create_mesh())``, the JAX draws handed
  in: samples at the tolerances of ``tests/test_multichip_sampling.py``
  (rtol 2e-4, atol 1e-4), counters and modes exactly, float telemetry at
  rel 1e-5 (reduction order).  Without injected draws a mesh run equals the
  single-process run of the same generator (each rank draws the whole batch).
* Trainer: dp = 2 × tp = 2 against the data-only dp = 2 run and both against
  the single-process trainer, with ``fdtpu``'s
  ``test_trainer_tp_mesh_matches_data_only`` tolerances (best val loss rtol
  1e-4; parameters rtol 1e-4, atol 1e-5): the host loop, ``steps_per_call``,
  ``epochs_per_call`` (whose zero-weight padding of an uneven last batch
  keeps the exact mean), accumulation; a resume reproduces the uninterrupted
  mesh run bitwise; the checkpoint written under the mesh is full-shape.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import torch_dist_workers as workers
from fdtpu.diffusion import VPScheduler as JaxVP
from fdtpu.dist import mesh as jmesh
from fdtpu.models import score_models as jsm
from fdtpu.sampling import sampler as jsampler
from fdtpu_torch.data import SyntheticDatamodule
from fdtpu_torch.diffusion import VPScheduler
from fdtpu_torch.dist import mesh as pmesh
from fdtpu_torch.models import ScoreModel, ScoreModelConfig, init_score_model
from fdtpu_torch.sampling import DiffusionSampler
from fdtpu_torch.train import Trainer, get_training_params
from fdtpu_torch.utils.convert import load_jax_variables

TOL = dict(rtol=2e-4, atol=1e-4)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ mesh helpers
@pytest.mark.parametrize("config, n", [((-1, 1), 8), ((-1, 2), 8), ((2, 4), 8), ((4, 1), 4),
                                       ((3, 1), 8), ((-1, 3), 8)])
def test_mesh_config_resolves_as_jax(config, n):
    data, model = config
    want = got = None
    try:
        want = jmesh.MeshConfig(data=data, model=model).resolve(n)
    except ValueError as exc:
        with pytest.raises(ValueError, match="does not cover"):
            pmesh.MeshConfig(data=data, model=model).resolve(n)
        assert "does not cover" in str(exc)
        return
    got = pmesh.MeshConfig(data=data, model=model).resolve(n)
    assert got == want


@pytest.mark.parametrize("n, multiple", [(5, 2), (6, 3), (7, 4), (1, 8)])
def test_pad_to_multiple_matches_jax(n, multiple):
    batch = np.random.default_rng(n).standard_normal((n, 3, 2)).astype(np.float32)
    got, got_n = pmesh.pad_to_multiple(batch, multiple)
    want, want_n = jmesh.pad_to_multiple(batch, multiple)
    assert got_n == want_n == n
    np.testing.assert_array_equal(got, want)


TP_CFG = dict(n_channels=1, max_len=16, d_model=8, num_layers=2, n_head=4, dim_feedforward=16)


def _jax_and_port(**kw):
    cfg = dict(TP_CFG, **kw)
    variables = jax.tree.map(np.asarray, jsm.init_score_model(jax.random.PRNGKey(0),
                                                              jsm.ScoreModelConfig(**cfg)))
    net = init_score_model(ScoreModelConfig(**cfg), device="cpu")
    load_jax_variables(net, variables)
    return variables, net


# The port's layer parameters and the JAX leaves they load from
# (fdtpu_torch/utils/convert.py): a torch Linear keeps (out, in), the JAX
# leaf (L, in, out).
JAX_LEAF = {"in_proj_weight": ("attn", "in_proj_w"), "in_proj_bias": ("attn", "in_proj_b"),
            "out_proj.weight": ("attn", "out_w"), "out_proj.bias": ("attn", "out_b"),
            "linear1.weight": ("linear1", "w"), "linear1.bias": ("linear1", "b"),
            "linear2.weight": ("linear2", "w"), "linear2.bias": ("linear2", "b")}


def test_tp_param_spec_shards_the_axes_the_jax_spec_shards():
    """Every parameter the JAX spec shards over ``model`` is sharded here on
    the same logical axis (the output features of a column-parallel layer,
    the input features of a row-parallel one), and nothing else is; the
    in-projection is seen as 3 blocks (q, k, v), so it splits per head."""
    variables, net = _jax_and_port()
    jspecs = {}
    jax.tree_util.tree_map_with_path(
        lambda path, x: jspecs.__setitem__(tuple(k.key for k in path),
                                           jmesh.tp_param_spec(path, x)),
        variables["params"])
    seen = 0
    for name, p in net.named_parameters():
        placement, blocks = pmesh.tp_param_spec(name, p)
        short = name.split(".", 2)[-1] if name.startswith("backbone.") else None
        if short not in JAX_LEAF:
            assert (placement, blocks) == (Replicate(), 1), name
            continue
        spec = jspecs[("backbone",) + JAX_LEAF[short]]
        if "model" not in spec:
            assert (placement, blocks) == (Replicate(), 1), name
            continue
        seen += 1
        # JAX (L, in, out) or (L, out): "model" last → output features → dim 0 here.
        output_axis = spec.index("model") == len(spec) - 1
        assert placement == Shard(0 if output_axis else 1), (name, spec)
        assert blocks == (3 if short.startswith("in_proj") else 1), name
    assert seen == 6 * TP_CFG["num_layers"]


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_in_projection_is_placed_per_head(tp):
    """Rank r of tp holds the q, k and v rows of heads r·H/tp … (r+1)·H/tp −
    1 of the JAX in-projection (the JAX spec's contiguous split would give
    rank 0 all of q at tp = 2); the pieces join back to the whole."""
    variables, net = _jax_and_port()
    d, h = TP_CFG["d_model"], TP_CFG["n_head"]
    dh = d // h
    w_jax = np.asarray(variables["params"]["backbone"]["attn"]["in_proj_w"][0]).T  # (3D, D)
    full = net.backbone[0].in_proj_weight.detach()
    np.testing.assert_array_equal(full.numpy(), w_jax)
    spec = pmesh.tp_param_spec("backbone.0.in_proj_weight", full)
    parts = [pmesh.tp_slice(full, *spec, tp, r) for r in range(tp)]
    per = h // tp
    for r, part in enumerate(parts):
        heads = slice(r * per * dh, (r + 1) * per * dh)
        want = np.concatenate([w_jax[j * d:(j + 1) * d][heads] for j in range(3)])
        np.testing.assert_array_equal(part.numpy(), want)
    assert torch.equal(pmesh.tp_join(parts, *spec), full)
    assert pmesh.data_sharding(None, 3) == (Shard(0), Replicate())


@pytest.mark.parametrize("tp, ok", [(1, True), (2, True), (4, True), (3, False), (8, False)])
def test_a_model_axis_must_split_the_heads_and_the_ffn(tp, ok):
    """Here 4 heads and 16 FFN units; the flagship's 12 heads and 2048 units
    take tp ∈ {1, 2, 4} (3, 6 and 12 split the heads, not the FFN)."""
    if ok:
        pmesh.check_model_axis(tp, TP_CFG["n_head"], TP_CFG["dim_feedforward"])
    else:
        with pytest.raises(ValueError, match="does not divide"):
            pmesh.check_model_axis(tp, TP_CFG["n_head"], TP_CFG["dim_feedforward"])
    for flagship_tp in (1, 2, 4):
        pmesh.check_model_axis(flagship_tp, 12, 2048)
    for flagship_tp in (3, 6, 12):
        with pytest.raises(ValueError, match="does not divide"):
            pmesh.check_model_axis(flagship_tp, 12, 2048)


def test_create_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialized process group"):
        pmesh.create_mesh(device_type="cpu")


# ----------------------------------------------------------------- sampler
SMALL = dict(n_channels=2, max_len=16, d_model=8, num_layers=2, n_head=4, dim_feedforward=32)
BS, STEPS, BETA_MAX = 8, 8, 2.0
LEVELS = {
    # name: (cache_kwargs or None, sampler options, batches, batches_per_call, JAX reference)
    "uncached": (None, {}, 1, 1, True),
    "score": (dict(level="score", R=3, tau_0=0.05), {}, 2, 1, True),
    "token": (dict(level="token", token_budget=4, tau_0=5.0, R=6, random_probe_ratio=0.2,
                   guard="off"), {}, 1, 1, True),
    "kv-event": (dict(level="kv", policy="event", K=1, R=4, tau_0=1.0, tau_warn=1e9,
                      random_probe_ratio=0.1, use_freqca=True, freq_decomp_interval=3),
                 {}, 1, 1, True),
    "score-fresca": (dict(level="score", R=3, tau_0=0.05), dict(use_fresca=True), 1, 1, False),
    "score-freqca": (dict(level="score", R=6, tau_0=0.6, eps_predictor="freqca", max_history=4,
                          hermite_order=2, guard="off"), {}, 1, 1, False),
    "score-resident": (dict(level="score", R=3, tau_0=0.05), {}, 2, 2, False),
    "token-resident": (dict(level="token", token_budget=4, tau_0=5.0, R=6,
                            random_probe_ratio=0.2, guard="off"), {}, 2, 2, False),
    "kv-resident": (dict(level="kv", policy="event", K=1, R=4, tau_0=1.0, tau_warn=1e9,
                         random_probe_ratio=0.1), {}, 2, 2, False),
}


def _jax_draws(seed, num_batches, probes):
    """The JAX DiffusionSampler's prior, step and probe draws, per batch."""
    key = jax.random.PRNGKey(seed)
    prior, steps, uniforms = [], [], []
    shape = (BS, SMALL["max_len"], SMALL["n_channels"])
    for _ in range(num_batches):
        key, k_prior, k_chain = jax.random.split(key, 3)
        prior.append(np.array(jax.random.normal(k_prior, shape)))
        zs, us = [], []
        for _ in range(STEPS):
            if probes:
                k_chain, k_noise, k_probe = jax.random.split(k_chain, 3)
                us.append(np.array(jax.random.uniform(k_probe, (SMALL["max_len"],))))
            else:
                k_chain, k_noise = jax.random.split(k_chain)
            zs.append(np.array(jax.random.normal(k_noise, shape, jnp.float32)))
        steps.append(np.stack(zs))
        uniforms.append(np.stack(us) if probes else np.zeros((STEPS, SMALL["max_len"]),
                                                             np.float32))
    return dict(prior_noise=torch.from_numpy(np.concatenate(prior)),
                step_noise=torch.from_numpy(np.concatenate(steps, 1)),
                probe_noise=torch.from_numpy(np.stack(uniforms)) if probes else None)


@pytest.fixture(scope="module")
def sampling(tmp_path_factory):
    """The JAX model and the port's, the cases, their single-process and JAX
    references, and each world's mesh results."""
    jcfg = jsm.ScoreModelConfig(**SMALL)
    variables = jsm.init_score_model(jax.random.PRNGKey(3), jcfg)
    net = init_score_model(ScoreModelConfig(**SMALL), device="cpu")
    load_jax_variables(net, jax.tree.map(np.asarray, variables))
    sched = dict(fourier_noise_scaling=True, beta_max=BETA_MAX)
    jmodel = jsm.ScoreModel(config=jcfg, variables=variables,
                            scheduler=JaxVP(**sched).with_noise_scaling(SMALL["max_len"]))
    pmodel = ScoreModel(net.config, net,
                        VPScheduler(**sched).with_noise_scaling(SMALL["max_len"], "cpu"))
    cases, single, jax_ref = [], {}, {}
    for name, (kw, options, batches, per_call, with_jax) in LEVELS.items():
        probes = kw is not None and kw["level"] != "score"
        for injected in (True, False):
            draws = _jax_draws(11, batches, probes) if injected else None
            case = dict(name=f"{name}/{'jax' if injected else 'gen'}", cache_kwargs=kw,
                        options=options, batch=BS, per_call=per_call, num_samples=batches * BS,
                        steps=STEPS, seed=5, draws=draws)
            cases.append(case)
            sampler = DiffusionSampler(pmodel, BS, use_cache=kw is not None, cache_kwargs=kw or {},
                                       batches_per_call=per_call, **options)
            run = draws or {"generator": torch.Generator().manual_seed(5)}
            single[case["name"]] = (sampler.sample(batches * BS, STEPS, **run),
                                    sampler.get_cache_stats(), sampler.last_modes)
            if injected and with_jax:
                js = jsampler.DiffusionSampler(jmodel, BS, use_cache=kw is not None,
                                               cache_kwargs=kw or {}, mesh=jmesh.create_mesh(),
                                               **options)
                jax_ref[case["name"]] = (js.sample(batches * BS, STEPS,
                                                   key=jax.random.PRNGKey(11)),
                                         js.get_cache_stats())
    payload = dict(config=SMALL, state=net.state_dict(), scheduler=sched, cases=cases)
    meshes = {world: workers.launch("sample", world, tmp_path_factory.mktemp(f"s{world}"),
                                    payload) for world in (2, 4)}
    return single, jax_ref, meshes


def _same_stats(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, value in want.items():
        # Counters exactly; float telemetry up to the reduction order.
        assert got[key] == pytest.approx(value, rel=1e-5), key


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(LEVELS))
def test_mesh_sampler_matches_the_single_process_sampler_and_jax(sampling, world, name):
    single, jax_ref, meshes = sampling
    for case in (f"{name}/jax", f"{name}/gen"):
        want_x, want_stats, want_modes = single[case]
        for rank, result in enumerate(meshes[world]):
            got = result[case]
            assert got["x"].shape == want_x.shape, (case, rank)
            np.testing.assert_allclose(got["x"].numpy(), want_x.numpy(), **TOL)
            # Every rank returns the same whole batch.
            assert torch.equal(got["x"], meshes[world][0][case]["x"])
            _same_stats(got["stats"], want_stats)
            if want_modes is None:
                assert got["modes"] is None
            else:
                assert torch.equal(got["modes"], want_modes), (case, rank)
        if case in jax_ref:
            jx, jstats = jax_ref[case]
            np.testing.assert_allclose(meshes[world][0][case]["x"].numpy(), jx, **TOL)
            _same_stats(meshes[world][0][case]["stats"], jstats)


def test_resident_mesh_chain_equals_the_eager_mesh_loop(sampling):
    """The resident chain on a mesh runs the eager loop's functions: the
    same samples and modes, bitwise."""
    _, _, meshes = sampling
    for world in (2, 4):
        for level in ("score", "token", "kv"):
            eager = meshes[world][1][f"{'kv-event' if level == 'kv' else level}/gen"]
            resident = meshes[world][1][f"{level}-resident/gen"]
            # The eager cases of the token and KV levels run the first of
            # the resident case's two batches (KV: without FreqCa's ring).
            n = eager["x"].shape[0]
            if level != "kv":
                assert torch.equal(eager["x"], resident["x"][:n]), (world, level)
                assert torch.equal(eager["modes"], resident["modes"][:len(eager["modes"])])
            assert resident["modes"].shape == (2, STEPS)


def test_sampler_mesh_must_split_the_batch():
    net = init_score_model(ScoreModelConfig(**SMALL), device="cpu")
    model = ScoreModel(net.config, net, VPScheduler().with_noise_scaling(16, "cpu"))
    with pytest.raises(TypeError, match="DeviceMesh"):
        DiffusionSampler(model, BS, mesh="data")


# ----------------------------------------------------------------- trainer
TRAIN_CFG = dict(n_channels=1, max_len=16, d_model=8, num_layers=2, n_head=4,
                 dim_feedforward=16, dropout=0.1)


def _datamodule(path, batch_size=16):
    kw = dict(data_dir=str(path), max_len=16, num_samples=70, batch_size=batch_size,
              fourier_transform=True, standardize=True, random_seed=2)
    dm = SyntheticDatamodule(**kw)
    dm.prepare_data()
    dm.setup()
    return kw, dm


TRAIN_RUNS = {
    # name: (Trainer kwargs, epochs of the schedule)
    "host": (dict(max_epochs=1, steps_per_call=1), 1),
    "graphed": (dict(max_epochs=1, steps_per_call=16), 1),
    "resident": (dict(max_epochs=2, epochs_per_call=2), 2),
    "accumulate": (dict(max_epochs=2, steps_per_call=1, accumulate_grad_batches=2), 2),
    "uninterrupted": (dict(max_epochs=2, steps_per_call=1), 2),
}


@pytest.fixture(scope="module")
def training(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    dm_kw, dm = _datamodule(tmp / "data")
    net = init_score_model(ScoreModelConfig(**TRAIN_CFG), torch.Generator().manual_seed(0),
                           device="cpu")
    sched = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(16, "cpu")

    def steps(epochs, accumulate=1):
        return get_training_params(dm, epochs, accumulate)["num_training_steps"]

    runs, single = [], {}
    for name, (kw, epochs) in TRAIN_RUNS.items():
        n = steps(epochs, kw.get("accumulate_grad_batches", 1))
        runs.append(dict(name=name, trainer=dict(kw, save_resume_state=name == "uninterrupted"),
                         num_training_steps=n))
        if name == "uninterrupted":  # held to the resumed mesh run, not to one process
            continue
        model = ScoreModel(net.config, init_score_model(net.config, device="cpu"), sched,
                           num_training_steps=n)
        model.network.load_state_dict(net.state_dict())
        trainer = Trainer(run_dir=tmp / "single", run_id=name, seed=1, log_every_n_steps=1,
                          save_resume_state=False, **kw)
        single[name] = (trainer.fit(model, dm), trainer)
    runs.append(dict(name="resumed", num_training_steps=steps(2),
                     stages=[dict(max_epochs=1, steps_per_call=1),
                             dict(max_epochs=2, steps_per_call=1, resume=True)]))
    # Batches of 15 (an uneven last one, 70 = 4 × 15 + 10) for the resident
    # loop's zero-weight padding to 16 rows.
    odd_kw, odd_dm = _datamodule(tmp / "odd", batch_size=15)
    odd = dict(name="odd", datamodule=odd_kw, trainer=dict(max_epochs=2, epochs_per_call=2,
                                                             save_resume_state=False),
               num_training_steps=get_training_params(odd_dm, 2)["num_training_steps"])
    runs.append(odd)
    jax_ref, jax_run = _jax_mesh_trainer(tmp)
    runs.append(jax_run)
    payload = dict(config=TRAIN_CFG, state=net.state_dict(), datamodule=dm_kw, runs=runs,
                   placement=jax_ref["placement"])
    tp = workers.launch("train", 4, tmp / "tp", payload, model=2)
    dp = workers.launch("train", 2, tmp / "dp",
                        dict(payload, runs=[r for r in runs if r["name"] == "host"]))
    dp_odd = workers.launch("train", 4, tmp / "dp_odd", dict(payload, runs=[odd]))
    return single, tp, dp, dp_odd, jax_ref


# fdtpu's test_trainer_tp_mesh_matches_data_only run: 64 samples in batches
# of 16, dropout off (the two packages draw dropout masks differently), JAX's
# default steps_per_call.
JAX_TRAIN_DM = dict(max_len=16, num_samples=64, batch_size=16, fourier_transform=True,
                    standardize=True, random_seed=2)
JAX_TRAIN_RUN = dict(max_epochs=2, steps_per_call=16, save_resume_state=False)


def _jax_step_draws(calls: int, batch: int, shape: tuple) -> list:
    """The JAX trainer's t and z of each loss call, in its order (per call
    ``key, step_key = split(key)``, then ``split(step_key, 3)`` for t, z and
    dropout), for the whole batch."""
    key, out = jax.random.PRNGKey(1), []
    for _ in range(calls):
        key, step_key = jax.random.split(key)
        key_t, key_z, _ = jax.random.split(step_key, 3)
        t = jax.random.uniform(key_t, (batch,), jnp.float32) * (1.0 - 1e-5) + 1e-5
        z = jax.random.normal(key_z, shape, jnp.float32)
        out.append((torch.from_numpy(np.array(t)), torch.from_numpy(np.array(z))))
    return out


def _jax_mesh_trainer(tmp: Path):
    """``fdtpu``'s ``Trainer(mesh=create_mesh(MeshConfig(model=2)))`` on
    conftest's 8 virtual devices (data 4 × model 2), its ``shard_batch`` and
    ``shard_params``; and the port's run of the same training for the dp 2
    × tp 2 workers, JAX's weights and draws handed in."""
    from fdtpu.data.datamodules import SyntheticDatamodule as JaxSynthetic
    from fdtpu.train.trainer import Trainer as JaxTrainer

    cfg = dict(TRAIN_CFG, dropout=0.0)
    jcfg = jsm.ScoreModelConfig(**cfg)
    # Held as numpy: the JAX trainer donates the arrays it is given.
    variables = jax.tree.map(np.asarray, jsm.init_score_model(jax.random.PRNGKey(0), jcfg))
    net = init_score_model(ScoreModelConfig(**cfg), device="cpu")
    load_jax_variables(net, variables)
    dm_kw = dict(JAX_TRAIN_DM, data_dir=str(tmp / "jax_data"))
    dm = SyntheticDatamodule(**dm_kw)
    dm.prepare_data()
    dm.setup()
    jdm = JaxSynthetic(data_dir=tmp / "jax_jaxdata", **JAX_TRAIN_DM)
    jdm.prepare_data()
    jdm.setup()
    n = get_training_params(dm, JAX_TRAIN_RUN["max_epochs"])["num_training_steps"]
    mesh = jmesh.create_mesh(jmesh.MeshConfig(model=2))
    assert mesh.shape == {"data": 4, "model": 2}
    jtrainer = JaxTrainer(run_dir=tmp / "jax", run_id="j", seed=1, log_every_n_steps=1,
                          mesh=mesh, **JAX_TRAIN_RUN)
    jmodel = jtrainer.fit(jsm.ScoreModel(
        config=jcfg, variables=variables, num_training_steps=n,
        scheduler=JaxVP(fourier_noise_scaling=True).with_noise_scaling(16)), jdm)
    best = init_score_model(ScoreModelConfig(**cfg), device="cpu")
    load_jax_variables(best, jax.tree.map(np.asarray, jmodel.variables))
    batch = np.random.default_rng(4).standard_normal((8, 3)).astype(np.float32)
    calls = JAX_TRAIN_RUN["max_epochs"] * (len(dm.train_dataloader()) + len(dm.val_dataloader()))
    run = dict(name="jax", config=cfg, state=net.state_dict(), datamodule=dm_kw,
               trainer=JAX_TRAIN_RUN, num_training_steps=n,
               draws=_jax_step_draws(calls, JAX_TRAIN_DM["batch_size"],
                                     (JAX_TRAIN_DM["batch_size"], 16, 1)))
    ref = dict(mesh=mesh, state=best.state_dict(), best_val_loss=jtrainer.best_val_loss,
               records=[json.loads(line) for line in jtrainer.metrics_path.read_text()
                        .splitlines()],
               batch=jmesh.shard_batch(mesh, batch),
               params=jmesh.shard_params(mesh, variables["params"]),
               placement=dict(batch=torch.from_numpy(batch), params=net.state_dict()))
    return ref, run


def _close(got: dict, want: dict) -> None:
    """Parameters at the JAX protocol's tolerances.  The in-projection's key
    bias is the exception: its gradient is zero but for rounding (a row's
    softmax does not change when one number is added to all its scores), and
    AdamW turns that noise into steps of up to the rate, so each side's key
    bias is held to that bound (the rate 1e-3 times the 10 updates at most)
    rather than to the other side."""
    assert got.keys() == want.keys()
    d = TRAIN_CFG["d_model"]
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        if k.endswith("in_proj_bias"):
            for side in (g, w):
                assert np.abs(side[d:2 * d]).max() <= 1e-3 * 10, k
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, err_msg=k, **TRAIN_TOL)


def test_tp_mesh_trainer_matches_the_data_only_mesh_and_one_process(training):
    """fdtpu's test_trainer_tp_mesh_matches_data_only, on the port: dp 2 ×
    tp 2 against dp 2, and both against the trainer without a mesh."""
    single, tp, dp, _, _ = training
    model, trainer = single["host"]
    for run in (tp, dp):
        for rank in run:
            got = rank["host"]
            assert np.isfinite(got["best_val_loss"])
            np.testing.assert_allclose(got["best_val_loss"], trainer.best_val_loss, rtol=1e-4)
            _close(got["state"], model.network.state_dict())
    _close(tp[0]["host"]["state"], dp[0]["host"]["state"])
    np.testing.assert_allclose(tp[0]["host"]["best_val_loss"], dp[0]["host"]["best_val_loss"],
                               rtol=1e-4)


def test_tp_mesh_trainer_matches_the_jax_mesh_trainer(training):
    """The port's dp 2 × tp 2 ``Trainer(mesh=)`` against ``fdtpu``'s
    ``Trainer(mesh=create_mesh(MeshConfig(model=2)))`` (data 4 × model 2)
    on the same weights, data and draws (JAX's t and z handed to every train
    and val loss, each rank keeping its rows): per-step losses, val losses,
    rates, the best val loss and the best-val parameters at
    ``test_trainer_tp_mesh_matches_data_only``'s tolerances."""
    _, tp, _, _, jax_ref = training
    for rank in tp:
        got = rank["jax"]
        np.testing.assert_allclose(got["best_val_loss"], jax_ref["best_val_loss"], rtol=1e-4)
        _close(got["state"], jax_ref["state"])
    records, want = tp[0]["jax"]["records"], jax_ref["records"]
    assert [sorted(r) for r in records] == [sorted(r) for r in want]
    assert sum("train/loss" in r for r in want) == 8
    for r, w in zip(records, want):
        assert (r["step"], r["epoch"]) == (w["step"], w["epoch"])
        for key in ("train/loss", "train/loss_epoch", "val/loss"):
            if key in w:
                np.testing.assert_allclose(r[key], w[key], rtol=1e-4, err_msg=f"{key} {w['step']}")
        np.testing.assert_allclose(r["lr"], w["lr"], rtol=1e-6, atol=1e-10)


def _jax_shard(array, mesh, data: int, model: int) -> np.ndarray:
    """The part of a placed JAX array on the device at (data, model)."""
    device = mesh.devices[data, model]
    return next(np.asarray(s.data) for s in array.addressable_shards if s.device == device)


def test_shard_batch_and_shard_params_match_jax(training):
    """``shard_batch`` on a data axis of 4 gives each rank the rows JAX's
    places on that data coordinate; ``shard_params`` on a model axis of 2
    gives each rank JAX's part of every parameter (a torch ``Linear`` keeps
    (out, in): the JAX part transposed), but for the in-projection, which the
    port places per head (the q, k and v rows of the rank's heads) where JAX
    places the 3D axis contiguously."""
    _, tp, _, dp_odd, jax_ref = training
    mesh, full = jax_ref["mesh"], jax_ref["placement"]["params"]
    for rank in dp_odd:
        data, _ = rank["coords"]
        np.testing.assert_array_equal(rank["placement"]["batch"].numpy(),
                                      _jax_shard(jax_ref["batch"], mesh, data, 0))
    d = TRAIN_CFG["d_model"]
    for rank in tp:
        _, model = rank["coords"]
        got = rank["placement"]["params"]
        assert got.keys() == full.keys()
        for name, part in got.items():
            short = name.split(".", 2)[-1] if name.startswith("backbone.") else None
            if short not in JAX_LEAF:
                assert torch.equal(part, full[name]), name
                continue
            a, b = JAX_LEAF[short]
            jpart = _jax_shard(jax_ref["params"]["backbone"][a][b], mesh, 0,
                               model)[int(name.split(".")[1])]
            jpart = jpart.T if jpart.ndim == 2 else jpart
            if short.startswith("in_proj"):
                rows = slice(model * d // 2, (model + 1) * d // 2)
                per_head = torch.cat([full[name][j * d:(j + 1) * d][rows] for j in range(3)])
                contiguous = full[name][model * 3 * d // 2:(model + 1) * 3 * d // 2]
                assert torch.equal(part, per_head), name
                np.testing.assert_array_equal(jpart, contiguous.numpy())
            else:
                np.testing.assert_array_equal(part.numpy(), jpart, err_msg=name)


@pytest.mark.parametrize("name", ["graphed", "resident", "accumulate"])
def test_tp_mesh_trainer_keeps_every_loop(training, name):
    """steps_per_call, epochs_per_call and accumulation on the dp 2 × tp 2
    mesh give the single-process trajectory; the logged records (rank 0's)
    are the same records."""
    single, tp, _, _, _ = training
    model, trainer = single[name]
    got = tp[3][name]
    np.testing.assert_allclose(got["best_val_loss"], trainer.best_val_loss, rtol=1e-4)
    _close(got["state"], model.network.state_dict())
    want = [json.loads(line) for line in trainer.metrics_path.read_text().splitlines()]
    records = tp[0][name]["records"]
    assert [r.keys() for r in records] == [r.keys() for r in want]
    for r, w in zip(records, want):
        for key in ("train/loss", "train/loss_epoch", "val/loss"):
            if key in w:
                np.testing.assert_allclose(r[key], w[key], rtol=1e-4, err_msg=key)


def test_uneven_last_batch_keeps_the_exact_mean_on_a_mesh(training):
    """Batches of 15 padded to 16 with zero-weight rows, as the JAX loop
    pads to ``B_pad``: over 4 data ranks (4 rows each, the padding row on the
    last) and over 2 data × 2 model ranks (8 rows each) the weighted loss over
    the whole batch's weights gives one trajectory.  (A single device draws
    the noise of 15 rows, not 16, so its trajectory is another one.)"""
    _, tp, _, dp_odd, _ = training
    want = tp[0]["odd"]
    for rank in dp_odd:
        np.testing.assert_allclose(rank["odd"]["best_val_loss"], want["best_val_loss"], rtol=1e-4)
        _close(rank["odd"]["state"], want["state"])


def test_mesh_resume_and_checkpoints_are_full_shape(training):
    """A run resumed on the mesh ends where the uninterrupted one does,
    bitwise; the best checkpoint rank 0 wrote holds the full parameters and
    loads into a network without a mesh."""
    single, tp, _, _, _ = training
    for rank in tp:
        a, b = rank["uninterrupted"]["state"], rank["resumed"]["state"]
        assert all(torch.equal(a[k], b[k]) for k in a)
    ckpt = tp[0]["host"]["checkpoint"]
    assert ckpt is not None and all(r["host"]["checkpoint"] is None for r in tp[1:])
    net = init_score_model(ScoreModelConfig(**TRAIN_CFG), device="cpu")
    net.load_state_dict(ckpt)
    _close(ckpt, tp[0]["host"]["state"])
    assert tp[1]["host"]["records"] is None



def test_train_cli_under_torchrun_trains_data_parallel(tmp_path):
    """``python -m fdtpu_torch.cli.train`` under torchrun's environment (two
    ranks, gloo with ``+device=cpu``): ``trainer.use_mesh`` (the config's
    default, true) trains on a data-only mesh over both; they agree on the
    run and only rank 0 writes its files; the result is the one-process
    CLI's (the 64 samples split into even batches)."""
    from fdtpu_torch.cli import train as train_cli

    argv = ["datamodule=synthetic", f"datamodule.data_dir={tmp_path / 'data'}",
            "datamodule.max_len=16", "datamodule.num_samples=64", "fourier_transform=true",
            "trainer.max_epochs=1", "score_model.d_model=8", "score_model.num_layers=1",
            "score_model.n_head=2", "score_model.dim_feedforward=16", "+device=cpu"]
    single = train_cli.main(argv + [f"run_dir={tmp_path / 'single'}"]).trainer
    workers.launch_cli(2, tmp_path, argv + [f"run_dir={tmp_path / 'mesh'}"])
    ranks = [json.loads((tmp_path / "out" / f"{r}.json").read_text()) for r in range(2)]
    assert ranks[0]["run_dir"] == ranks[1]["run_dir"]
    np.testing.assert_allclose(ranks[1]["best"], single.best_val_loss, rtol=1e-4)
    run = Path(ranks[0]["run_dir"])
    written = sorted(p.relative_to(run).as_posix() for p in run.rglob("*") if p.is_file())
    assert "metrics.jsonl" in written and "train_config.yaml" in written
    assert any(w.startswith("checkpoints/") for w in written)
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    want = [json.loads(line) for line in single.metrics_path.read_text().splitlines()]
    # One writer: the records appear once each.
    assert len(records) == len(want)
