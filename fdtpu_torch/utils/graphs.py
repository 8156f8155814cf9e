"""Segments of a host loop as captured CUDA graphs, and the launch counts
their replays make (the trainer's ``steps_per_call``,
:class:`~fdtpu_torch.train.trainer.GraphedSteps`).

The JAX package runs many steps in one dispatch (``lax.scan``); the port's
counterpart is the CUDA graph.  A loop that branches on the host is cut into
segments, one per branch the host can take, each keyed by the host values
its Python code reads (a mode, whether a micro-step updates).
:meth:`GraphRunner.run` runs a segment:

* the first time a key is met, the segment runs eagerly on a side stream —
  a real step of the loop, which also builds every kernel library it needs
  and creates the cuBLAS, cuFFT and cuSOLVER handles and plans, so that no
  ``nvcc``, ``ctypes.CDLL`` or lazy initialisation runs inside a capture —
  and is then captured into a graph in a memory pool shared by the runner's
  graphs;
* every later time the graph is replayed.

A segment reads and writes only static tensors (allocated before the first
run and kept alive by its caller): a graph freezes every tensor address and
host value it was captured with.  The random draws of a segment come from
generators registered with every graph, so each replay advances them as the
eager draws would.  A capture that fails raises: there is no eager retry.

The kernel wrappers count their launches on the host, and a replay makes no
host call: each graph records how many launches of each kernel its capture
made (the counters are put back as they were after the capture, which
launched nothing) and adds them at every replay.

A runner made for a CPU device runs every segment directly.  The sampler's
chains, whose branches are decided on the device, are one graph each
(:mod:`fdtpu_torch.utils.conditional`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Hashable, Iterable, Iterator, Optional

import torch

from fdtpu_torch.kernels import attention as _mha
from fdtpu_torch.kernels import blockdiag_attention as _bda
from fdtpu_torch.kernels import chain_step as _step
from fdtpu_torch.kernels import ffn as _ffn
from fdtpu_torch.utils.profiling import span

# The launch counters of the kernel wrappers: B1, B2, B3's backward passes,
# B4, the score chain's step kernels, F1.
COUNTERS = ((_bda, "launches"), (_bda, "launches_bwd"), (_bda, "launches_trainable"),
            (_mha, "launches"), (_step, "launches_pre"), (_step, "launches_skip"),
            (_step, "launches_post"), (_ffn, "launches"))


def launch_counts() -> tuple[int, ...]:
    return tuple(getattr(module, name) for module, name in COUNTERS)


def set_counts(counts: Iterable[int]) -> None:
    for (module, name), n in zip(COUNTERS, counts):
        setattr(module, name, n)


def add_counts(counts: Iterable[int]) -> None:
    """Add launches made on the device without a host call (a replay's)."""
    set_counts(a + b for a, b in zip(launch_counts(), counts))


@contextlib.contextmanager
def uncounted() -> Iterator[list[int]]:
    """Leave the enclosed block's launches off the counts (a warm-up's, a
    capture's, which launches nothing): the counters are put back as they
    were when the block ends, however it ends.  Yields a list that then
    holds the launches the block made of each counter (what a captured
    graph adds at every replay)."""
    before = launch_counts()
    made: list[int] = []
    try:
        yield made
    finally:
        made.extend(a - b for a, b in zip(launch_counts(), before))
        set_counts(before)


class CudaGraph:
    """One ``torch.cuda.CUDAGraph`` in a shared pool, with its generators."""

    def __init__(self, pool, generators: tuple[torch.Generator, ...]) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool
        for gen in generators:
            self.graph.register_generator_state(gen)

    @staticmethod
    def warm_up(fn: Callable[[], None]) -> None:
        """Run ``fn`` eagerly on a side stream, ordered after and before the
        current stream's work."""
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)

    def capture(self, fn: Callable[[], None]) -> None:
        with torch.cuda.graph(self.graph, pool=self.pool):
            fn()

    def replay(self) -> None:
        self.graph.replay()


class GraphRunner:
    """Captured segments of one loop (module docstring), keyed by the host
    values their code branches on.  ``graph_type`` None runs every segment
    directly (a CPU loop); tests may pass a fake graph class."""

    def __init__(self, graph_type: Optional[type] = None,
                 generators: Iterable[torch.Generator] = ()) -> None:
        self.graph_type = graph_type
        self.generators = tuple(generators)
        self.pool = torch.cuda.graph_pool_handle() if graph_type is CudaGraph else None
        self.graphs: dict[Hashable, tuple[object, tuple[int, ...]]] = {}
        self.replays = 0

    @classmethod
    def for_device(cls, device: torch.device,
                   generators: Iterable[torch.Generator] = ()) -> "GraphRunner":
        """Graphs on a CUDA device, direct calls on the CPU."""
        return cls(CudaGraph if torch.device(device).type == "cuda" else None, generators)

    @property
    def captures(self) -> bool:
        return self.graph_type is not None

    def run(self, key: Hashable, fn: Callable[[], None]) -> None:
        """Run the segment ``key`` (``fn`` is its code; see the module
        docstring)."""
        if self.graph_type is None:
            fn()
            return
        entry = self.graphs.get(key)
        if entry is None:
            with span("fdtpu.graph.capture"):
                self.graph_type.warm_up(fn)
                self.graphs[key] = self._capture(fn)
            return
        graph, launched = entry
        graph.replay()
        self.replays += 1
        add_counts(launched)

    def _capture(self, fn: Callable[[], None]) -> tuple[object, tuple[int, ...]]:
        graph = self.graph_type(self.pool, self.generators)
        with uncounted() as launched:
            graph.capture(fn)
        return graph, tuple(launched)


def write_back(targets: dict[str, torch.Tensor], values: dict[str, torch.Tensor]) -> None:
    """Copy each new value into its static tensor, in place.  A value that
    is, or shares storage with, a static tensor (``eps_prev`` taking the old
    ``eps_hat``) is cloned first, so no copy reads a tensor another copy has
    already overwritten; a value that is its own static tensor (a store
    updated in place) is left as it is."""
    static = {t.untyped_storage().data_ptr() for t in targets.values() if t.numel()}
    pending = {}
    for name, value in values.items():
        target = targets[name]
        if value is target:
            continue
        if value.numel() and value.untyped_storage().data_ptr() in static:
            value = value.clone()
        pending[name] = value
    for name, value in pending.items():
        targets[name].copy_(value)
