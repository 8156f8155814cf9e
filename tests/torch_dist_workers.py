"""The processes of ``tests/test_torch_dist.py``: one gloo rank each, on the
CPU, started by :func:`launch` with ``spawn`` (a fresh interpreter that
imports torch and the port, never JAX).

A job is a function ``job(mesh, payload, tmp, rank) -> result`` of this
module, named in :data:`JOBS`; the payload and each rank's result pass
through ``torch.save`` files under the test's ``tmp_path``, and the ranks
meet through a ``file://`` store there (no port, so xdist workers cannot
collide).
"""

from __future__ import annotations

import json
import os
import socket
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

START_TIMEOUT_S = 240


def launch(job: str, world: int, tmp: Path, payload, model: int = 1) -> list:
    """Run ``JOBS[job]`` on a ``world``-rank gloo mesh with a ``model`` axis
    of ``model``; returns each rank's result, in rank order."""
    tmp = Path(tmp)
    (tmp / "out").mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp / "payload.pt")
    _run(_main, (world, model, str(tmp), job), world, tmp)
    return [torch.load(tmp / "out" / f"{r}.pt", weights_only=False) for r in range(world)]


def _run(fn, args: tuple, world: int, tmp: Path) -> None:
    """``fn(rank, *args)`` in ``world`` spawned processes, joined within
    ``START_TIMEOUT_S``; a rank's error (its ``out/<rank>.err``) is raised."""
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False, start_method="spawn")
    waited = 0
    while not ctx.join(timeout=5):
        waited += 5
        if waited > START_TIMEOUT_S:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} on {world} ranks did not end in "
                               f"{START_TIMEOUT_S} s")
    errors = sorted((tmp / "out").glob("*.err"))
    if errors:
        raise RuntimeError(errors[0].read_text())


def launch_cli(world: int, tmp: Path, argv: list[str]) -> None:
    """Run ``python -m fdtpu_torch.cli.train argv`` as ``torchrun
    --nproc-per-node world`` would: each rank with torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``
    on a free localhost port), the CLI starting the process group itself."""
    tmp = Path(tmp)
    (tmp / "out").mkdir(parents=True, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    _run(_cli_main, (world, port, str(tmp), argv), world, tmp)


def _cli_main(rank: int, world: int, port: int, tmp: str, argv: list[str]) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        from fdtpu_torch.cli import train

        runner = train.main(argv)
        assert not dist.is_initialized()
        (Path(tmp) / "out" / f"{rank}.json").write_text(json.dumps(
            dict(run_dir=str(runner.trainer.run_dir), best=runner.trainer.best_val_loss)))
    except Exception:
        (Path(tmp) / "out" / f"{rank}.err").write_text(traceback.format_exc())
        raise


def _main(rank: int, world: int, model: int, tmp: str, job: str) -> None:
    tmp = Path(tmp)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=rank,
                            world_size=world)
    try:
        from fdtpu_torch.dist import MeshConfig, create_mesh

        mesh = create_mesh(MeshConfig(model=model), device_type="cpu")
        payload = torch.load(tmp / "payload.pt", weights_only=False)
        torch.save(JOBS[job](mesh, payload, tmp, rank), tmp / "out" / f"{rank}.pt")
    except Exception:
        (tmp / "out" / f"{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _network(payload, run=None):
    """The payload's network, or a run's own (its ``config`` and ``state``)."""
    from fdtpu_torch.models import ScoreModelConfig, init_score_model

    run = run or {}
    net = init_score_model(ScoreModelConfig(**run.get("config", payload["config"])), device="cpu")
    net.load_state_dict(run.get("state", payload["state"]))
    return net


class _InjectedDraws:
    """``sde_loss`` with a run's ``draws`` (the whole batch's t and z of each
    call, in order) in place of the generator's: each rank keeps its rows."""

    def __init__(self, real, draws):
        self.real, self.draws = real, iter(draws)

    def __call__(self, network, scheduler, x, generator=None, **kw):
        t, z = next(self.draws)
        rows = generator.data.rows(t.shape[0])
        return self.real(network, scheduler, x, generator=generator, timesteps=t[rows],
                         noise=z[rows], **kw)


def sample_job(mesh, payload, tmp, rank):
    """Each case of ``payload["cases"]`` through ``DiffusionSampler(mesh=mesh)``:
    the samples (the whole batch), the cache statistics, the modes."""
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel
    from fdtpu_torch.sampling import DiffusionSampler

    net = _network(payload)
    scheduler = VPScheduler(**payload["scheduler"]).with_noise_scaling(net.config.max_len, "cpu")
    model = ScoreModel(net.config, net, scheduler)
    out = {}
    for case in payload["cases"]:
        kw = case["cache_kwargs"]
        sampler = DiffusionSampler(model, case["batch"], use_cache=kw is not None,
                                   cache_kwargs=kw or {}, mesh=mesh,
                                   batches_per_call=case["per_call"], **case["options"])
        draws = case["draws"] or {"generator": torch.Generator().manual_seed(case["seed"])}
        x = sampler.sample(case["num_samples"], case["steps"], **draws)
        out[case["name"]] = dict(
            x=x, stats=sampler.get_cache_stats(),
            modes=None if sampler.last_modes is None else sampler.last_modes.clone())
    return out


def train_job(mesh, payload, tmp, rank):
    """Each run of ``payload["runs"]`` through ``Trainer(mesh=mesh)``: the
    best val loss, the returned network's parameters, the logged records
    and (rank 0) the best checkpoint's parameters; with the payload's
    ``placement``, this rank's ``shard_batch`` and ``shard_params`` of it."""
    from fdtpu_torch.data import SyntheticDatamodule
    from fdtpu_torch.diffusion import VPScheduler
    from fdtpu_torch.models import ScoreModel
    from fdtpu_torch.dist import shard_batch, shard_params
    from fdtpu_torch.train import Trainer, checkpoint
    from fdtpu_torch.train import trainer as trainer_mod

    scheduler = VPScheduler(fourier_noise_scaling=True).with_noise_scaling(
        payload["config"]["max_len"], "cpu")
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    if "placement" in payload:
        out["placement"] = dict(batch=shard_batch(mesh, payload["placement"]["batch"]),
                                params=shard_params(mesh, payload["placement"]["params"]))
    real_loss = trainer_mod.sde_loss
    for run in payload["runs"]:
        dm = SyntheticDatamodule(**run.get("datamodule", payload["datamodule"]))
        dm.setup()
        if "draws" in run:
            trainer_mod.sde_loss = _InjectedDraws(real_loss, run["draws"])
        try:
            for stage in run["stages"] if "stages" in run else [run["trainer"]]:
                net = _network(payload, run)
                model = ScoreModel(net.config, net, scheduler,
                                   num_training_steps=run["num_training_steps"])
                trainer = Trainer(run_dir=tmp / "runs", run_id=run["name"], seed=1,
                                  log_every_n_steps=1, mesh=mesh, **stage)
                model = trainer.fit(model, dm)
        finally:
            trainer_mod.sde_loss = real_loss
        ckpt = None
        if rank == 0 and trainer.best_checkpoint is not None:
            ckpt = checkpoint.load_network_state(trainer.best_checkpoint)
        records = ([json.loads(line) for line in trainer.metrics_path.read_text().splitlines()]
                   if rank == 0 else None)
        out[run["name"]] = dict(best_val_loss=trainer.best_val_loss,
                                state={k: v.clone() for k, v in model.network.state_dict().items()},
                                checkpoint=ckpt, records=records)
    return out


JOBS = {"sample": sample_job, "train": train_job}
