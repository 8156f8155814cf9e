"""The port's command-line entry points, composing the repository's
``configs/``: ``python -m fdtpu_torch.cli.train`` and
``python -m fdtpu_torch.cli.sample`` (ports of ``cli/train.py`` and
``cli/sample.py``), and the cache studies ``python -m
fdtpu_torch.cli.ablation_cache`` and ``python -m
fdtpu_torch.cli.benchmark_cache`` (ports of ``cli/ablation_cache.py`` and
``cli/benchmark_cache.py``), the Table-2 harness ``python -m
fdtpu_torch.cli.validate_real_data`` (port of
``scripts/validate_real_data.py``), and the export of the sampling program
``python -m fdtpu_torch.cli.export_sampler`` (port of
``cli/export_sampler.py``)."""
