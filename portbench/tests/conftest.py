"""The benchmark's CPU tests: ``python -m pytest portbench/tests`` from the
repository's root (the tests marked ``cuda`` need a card)."""

import copy
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import common  # noqa: E402


def tiny_cell(name: str):
    """A cell's files cut to a size a CPU test holds: narrow layers, few
    steps and rows (the training cell keeps its 365 days, which its
    datamodule requires)."""
    cell, traffic, config = common.cell_files(name)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    m = config["model"]
    m.update(d_model=12, num_layers=2, n_head=3, dim_feedforward=32)
    if "data" in config:
        config["data"].update(num_series=150, batch_size=16)
    else:
        m["max_len"] = 24
        traffic.update(num_samples=8, num_diffusion_steps=60)
        traffic["sampler"]["sample_batch_size"] = 4
        if traffic["check"].get("rows"):
            traffic["check"]["rows"] = 8
        if traffic["sampler"].get("cache_kwargs"):
            traffic["sampler"]["cache_kwargs"].update(R=10, tau_0=0.05)
    return cell, traffic, config


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
