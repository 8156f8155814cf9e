"""The port's command-line entry points: ``python -m fdtpu_torch.cli.train``
and ``python -m fdtpu_torch.cli.sample`` (ports of ``cli/train.py`` and
``cli/sample.py``), composing the repository's ``configs/``."""
