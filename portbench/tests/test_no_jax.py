"""No module a run loads has the top-level name jax, jaxlib, flax or fdtpu."""

import subprocess
import sys

from portbench import common


def test_whole_top_level_names():
    found = common.forbidden_loaded(["fdtpu_torch", "fdtpu_torch.models", "jaxtyping", "flaxen",
                                     "fdtpu", "fdtpu.models", "jax", "jax.numpy", "jaxlib.xla",
                                     "flax.linen", "numpy"])
    assert found == ["fdtpu", "fdtpu.models", "flax.linen", "jax", "jax.numpy", "jaxlib.xla"]


def test_a_run_loads_no_jax():
    """Every module of the harness and the port's modules it drives, loaded
    in a fresh process, leave no forbidden module behind."""
    code = (
        "import sys, pathlib; sys.path.insert(0, str(pathlib.Path('.').resolve()))\n"
        "import portbench.run, portbench.control, portbench.faults, portbench.readers\n"
        "import portbench.entries.sample, portbench.entries.train\n"
        "from portbench import common\n"
        "import fdtpu_torch.sampling, fdtpu_torch.train, fdtpu_torch.data, fdtpu_torch.kernels\n"
        "for m in common.manifest()['per_layer']: common.load_reader(m['name'])\n"
        "print(common.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for path in (common.BENCH_DIR / "reference").glob("*.py"):
        text = path.read_text()
        for name in ("fdtpu_torch", "import fdtpu", "from fdtpu", "jax"):
            assert name not in text, (path.name, name)
