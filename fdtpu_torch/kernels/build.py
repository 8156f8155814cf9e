"""Build and load the port's CUDA kernels.

Each source ``fdtpu_torch/kernels/csrc/<name>.cu`` is compiled on first use
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
``build/fdtpu_torch_kernels/lib<name>-<hash>.so`` at the repository root
(the hash is that of the source and the ``csrc/*.cuh`` headers, so an edited
source or header is rebuilt), and loaded
with ``ctypes``.  Nothing is compiled at import: the CPU-only test
environment imports every module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fdtpu_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# The encoder layer's kernels (B1, B2, F1): the first use of any builds all
# three, one ``nvcc`` each in parallel, since a forward on the card reaches B1
# and F1 within its first layer.
LAYER_SOURCES = ("blockdiag_attention", "blockdiag_attention_bwd", "ffn_block")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    # The source and every header beside it, so an edited header is rebuilt too.
    sha = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.read_bytes())
    digest = sha.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str], verbose: bool = False) -> dict[str, Path]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, so)
    errors = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        if verbose and log:
            print(log, end="")
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib
