"""Hygiene of the PyTorch port: ``fdtpu_torch`` (its CLIs included) and
``chip_smoke.py`` import neither JAX (``jax``, ``flax``, ``optax``,
``orbax``), nor the JAX package ``fdtpu``, nor PyYAML or pandas (the card's
machine has neither), anywhere; at import time they import only what the
card's machine has (the standard library, ``torch``, ``numpy``, ``scipy``,
``einops``, ``triton`` and the port itself), so ``h5py``, ``kaggle``,
``matplotlib`` and ``wandb`` are imported inside the functions that need
them; and they lint clean with the repository's own checker."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "fdtpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "flax", "optax", "orbax", "fdtpu", "yaml", "pandas"}
# What the card's machine has, besides the standard library.
AT_IMPORT = {"fdtpu_torch", "torch", "numpy", "scipy", "einops", "triton"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def _import_time_roots(path: Path) -> set[str]:
    """Roots imported when the module is imported: every import outside a
    function body (module level, class bodies, ``try`` and ``if`` blocks)."""
    roots = set()

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                roots.update(alias.name.split(".")[0] for alias in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                roots.add(child.module.split(".")[0])
            visit(child)

    visit(ast.parse(path.read_text(), filename=str(path)))
    return roots


def test_port_has_files():
    assert len(PORT_FILES) > 10
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"fdtpu_torch/cli/train.py", "fdtpu_torch/cli/sample.py",
            "fdtpu_torch/utils/config.py", "fdtpu_torch/dist/mesh.py",
            "fdtpu_torch/dist/parallel.py", "fdtpu_torch/dist/tensor_parallel.py",
            "fdtpu_torch/train/parallel.py", "fdtpu_torch/kernels/solve.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax_and_no_fdtpu(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_only_the_cards_packages_at_import_time(path):
    extra = _import_time_roots(path) - AT_IMPORT - set(sys.stdlib_module_names)
    assert not extra, f"{path.relative_to(REPO)} imports {sorted(extra)} at import time"


def test_import_time_scanner_skips_function_bodies(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nimport torch\ntry:\n    import h5py\nexcept ImportError:\n"
                   "    pass\nclass A:\n    import matplotlib\n    def f(self):\n"
                   "        import kaggle\ndef g():\n    import wandb\n")
    assert _import_time_roots(src) == {"os", "torch", "h5py", "matplotlib"}
    assert _imported_roots(src) >= {"kaggle", "wandb"}


def test_scanner_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom fdtpu.ops import dft\n"
                   "from fdtpu_torch.ops import idft\nimport optax\nimport yaml\n"
                   "from fdtpu_torch.utils import yaml_subset\n")
    assert _imported_roots(src) & FORBIDDEN == {"jax", "fdtpu", "optax", "yaml"}


@pytest.mark.parametrize("paths", [["fdtpu_torch", "chip_smoke.py"], ["tests"]])
def test_lint_clean(paths):
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts/lint.py"), *paths],
        cwd=REPO, capture_output=True, text=True,
    )
    assert proc.returncode == 0, f"lint problems:\n{proc.stdout}"
