"""FreqCa's Hermite solve as a registered operator, ``fdtpu::hermite_solve``.

``hermite_solve(a, b) -> x`` with ``a x = b``: the normal equations of
:func:`fdtpu_torch.ops.fourier.predict_hermite`, a small ``(order + 1)``
square system with one right-hand side per feature.  It is no kernel of this
repository (the JAX package solves with ``jnp.linalg.solve`` and has no
Pallas kernel here); it is an operator so that the library choice travels
with it:

* CPU — ``torch.linalg.solve_ex``;
* CUDA — the same solve with cuSOLVER pinned around it: PyTorch's default
  picks MAGMA at some shapes (this 4×4 system with a few hundred right-hand
  sides), whose ``getrs`` refuses CUDA-graph capture ("operation not
  permitted when stream is capturing"); cuSOLVER's captures at every shape,
  and is what the default picks at the flagship's 23,936 right-hand sides;
* a fake for tracing.

The sampler (eager and inside captured graphs) and a traced program
(``torch.export``, :mod:`fdtpu_torch.serve`) call the same operator, so the
program keeps the choice that a global setting around the call would not
carry into it, and the program's samples stay the sampler's.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _cusolver():
    previous = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(previous)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(a, b, check_errors=False).result


def _solve_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with _cusolver():
        return _solve(a, b)


# The operator's registration, kept alive with the module.
_OPS = torch.library.Library("fdtpu", "FRAGMENT")
_OPS.define("hermite_solve(Tensor a, Tensor b) -> Tensor")
_OPS.impl("hermite_solve", _solve, "CPU")
_OPS.impl("hermite_solve", _solve_cuda, "CUDA")


@torch.library.register_fake("fdtpu::hermite_solve")
def _hermite_solve_fake(a, b):
    # LAPACK's layout, as the solve returns it: column-major (n, k).
    return b.new_empty(b.shape[::-1]).mT


def hermite_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x`` with ``a x = b`` (module docstring); nothing is read back to the
    host: a singular system is not checked."""
    return torch.ops.fdtpu.hermite_solve.default(a, b)
