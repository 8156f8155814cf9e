"""fdtpu_torch — the PyTorch/CUDA port of fdtpu for NVIDIA Hopper (H100).

A second package beside the JAX reference ``fdtpu``: the same packed
orthonormal real-DFT diffusion, score network and E²-CRF sampler, written in
PyTorch idiom, with every Pallas kernel on the ported path replaced by a
hand-written Hopper kernel (``fdtpu_torch/kernels``).  It imports neither JAX
nor ``fdtpu``; only the tests import both.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`fdtpu_torch.utils.device.resolve_device`).

Ported so far (the serving path): spectral ops, VP/VE schedulers, the
transformer score model with the block-diagonal attention kernel, the
score-level E²-CRF cache, the reverse Euler–Maruyama sampler, and the
synthetic datamodule.  What is still to port is listed in ROADMAP.md.
"""

__version__ = "0.1.0"
