"""fdtpu_torch — the PyTorch/CUDA port of fdtpu for NVIDIA Hopper (H100).

A second package beside the JAX reference ``fdtpu``: the same packed
orthonormal real-DFT diffusion, score network and E²-CRF sampler, written in
PyTorch idiom, with every Pallas kernel on the ported path replaced by a
hand-written Hopper kernel (``fdtpu_torch/kernels``).  It imports neither JAX
nor ``fdtpu``; only the tests import both.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`fdtpu_torch.utils.device.resolve_device`).

Ported so far: spectral ops, FreqCa and FreSca, VP/VE schedulers, the
transformer (with the hand-written attention kernels), MLP and LSTM score
networks, the E²-CRF cache at the score, token and KV levels, the reverse
Euler–Maruyama sampler (grouped batches as CUDA graphs), τ₀ calibration, the
Wasserstein metrics, training (gradient accumulation, checkpoints, exact
resume, callbacks, optional wandb), config composition and the train and
sample CLIs (``python -m fdtpu_torch.cli.train`` / ``.sample``, on the card
unless ``+device=cpu``), the six datamodules, the cache-study CLIs, the
Table-2 harness (``python -m fdtpu_torch.cli.validate_real_data``), the
plots and tables of runs and datasets (``fdtpu_torch.viz``), the
reference-checkpoint migration, and the export of the sampling program for
serving (``fdtpu_torch.serve``, ``python -m fdtpu_torch.cli.export_sampler``).
What is still to port is listed in ROADMAP.md.
"""

__version__ = "0.1.0"
