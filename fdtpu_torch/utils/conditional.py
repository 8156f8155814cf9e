"""A whole loop with branches decided on the device, as one CUDA graph.

The JAX package compiles a reverse trajectory into one program: ``lax.scan``
over the steps, ``lax.cond`` / ``lax.switch`` on the cache's decision inside
(``fdtpu/sampling/sampler.py``).  Here the same shape is a CUDA graph with
conditional nodes (``csrc/conditional.cu``)::

    prologue ─► WHILE (clock[0] < limit) {
                    pre ─► set IF handles from mode ─► IF (mode == 0) { branch 0 }
                        ─► … ─► IF (mode == n-1) { branch n-1 } ─► post ─► set WHILE handle
                }

Each of ``pre``, the branches and ``post`` is a *segment*: a function of
static tensors captured by PyTorch into a graph that is never launched on
its own (``torch.cuda.CUDAGraph(keep_graph=True)``) and is put into the loop
as a child-graph node.  ``pre`` writes the step's branch index into ``mode``
(a 0-d int64 tensor) and ``post`` advances ``clock[0]``; the setter kernels
read them on the device.  The loop is appended, by the runtime API, to a
PyTorch capture of ``prologue`` (:class:`LoopGraph`), so replaying that graph
runs the prologue and then every step, with no host work in between.

Memory.  The segments share one memory pool, the loop graph has another:
a segment's temporaries are dead when it ends and segments run one after
another, so they may share addresses; the prologue's cannot, since they are
allocated after the segments were captured.  What a segment hands to another
goes through static tensors, allocated outside any capture by the caller.

Random numbers.  A draw captured in a segment would take the same Philox
offset at every iteration of the loop.  Segments therefore draw nothing:
the prologue draws what the whole loop needs, with the generators
registered with the loop graph, whose replays advance them.

Launch counts.  A replay does not tell the host which branches ran.  Each
segment records the launches of the counted kernels (B1–B4 and the score
chain's step kernels, :data:`~fdtpu_torch.utils.graphs.COUNTERS`) that its
capture made, and then its kernel nodes, counted once from the captured
graph; the caller multiplies them by how often each segment ran, a device
count it reads once (:meth:`LoopGraph.launches`).  A step adds the setter kernels.  Counting
the nodes is a diagnostic: where the runtime cannot count them, a warning
says so and :attr:`LoopGraph.counted` is False.

A capture that fails raises; there is no eager retry.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Callable, Iterable, Optional, Sequence

import torch

from fdtpu_torch.kernels import build
from fdtpu_torch.utils.graphs import uncounted

SOURCE = "conditional"
MAX_BRANCHES = 8
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        vp, p_vp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        p_u64 = ctypes.POINTER(ctypes.c_ulonglong)
        lib.fdtpu_cond_begin_while.argtypes = [vp, ctypes.c_int, p_u64, p_vp]
        lib.fdtpu_cond_handle.argtypes = [vp, p_u64]
        lib.fdtpu_cond_add_if.argtypes = [vp, vp, ctypes.c_ulonglong, p_vp, p_vp]
        lib.fdtpu_cond_add_child.argtypes = [vp, vp, vp, p_vp]
        lib.fdtpu_cond_add_branch_setter.argtypes = [vp, vp, vp, p_u64, ctypes.c_int, p_vp]
        lib.fdtpu_cond_add_while_setter.argtypes = [vp, vp, vp, ctypes.c_longlong,
                                                    ctypes.c_ulonglong, p_vp]
        lib.fdtpu_cond_count_kernels.argtypes = [vp, vp, p_u64]
        for name in ("begin_while", "handle", "add_if", "add_child", "add_branch_setter",
                     "add_while_setter", "count_kernels"):
            getattr(lib, f"fdtpu_cond_{name}").restype = ctypes.c_int
        lib.fdtpu_cond_error_string.argtypes = [ctypes.c_int]
        lib.fdtpu_cond_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _library().fdtpu_cond_error_string(err).decode()
        raise RuntimeError(f"conditional graph: {what} failed: {msg} (cudaError_t {err})")


def _kernel_nodes(lib, graph: Optional[int], stream=None) -> Optional[int]:
    """The kernel nodes of ``graph`` (None: of the graph ``stream`` is
    capturing, so far); None, with a warning, where the runtime cannot count
    them."""
    n = ctypes.c_ulonglong()
    err = lib.fdtpu_cond_count_kernels(graph, None if stream is None else stream.cuda_stream,
                                       ctypes.byref(n))
    if err != 0:
        msg = lib.fdtpu_cond_error_string(err).decode()
        warnings.warn(f"conditional graph: counting kernel nodes failed: {msg} "
                      f"(cudaError_t {err}); the chain's kernels go uncounted", RuntimeWarning)
        return None
    return n.value


class Segment:
    """A function of static tensors captured into a graph that only serves
    as a child-graph node; ``launched``: the counted launches its capture
    made, then its kernel nodes (0 where they could not be counted)."""

    def __init__(self, fn: Callable[[], None], pool) -> None:
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with uncounted() as launched, torch.cuda.graph(self.graph, pool=pool):
            fn()
        nodes = _kernel_nodes(_library(), self.raw)
        self.counted = nodes is not None
        self.launched = (*launched, nodes or 0)

    @property
    def raw(self) -> int:
        return self.graph.raw_cuda_graph()


class LoopGraph:
    """``prologue``, then ``pre``, one of ``branches`` (by ``mode``) and
    ``post`` while ``clock[0] < limit`` (module docstring).  ``pre`` may be
    None when there is one branch, which then runs every step.  Every
    function must already have run once outside a capture (the kernels
    built, the library handles made)."""

    def __init__(self, prologue: Callable[[], None], pre: Optional[Callable[[], None]],
                 branches: Sequence[Callable[[], None]], post: Callable[[], None],
                 mode: torch.Tensor, clock: torch.Tensor, limit: int,
                 generators: Iterable[torch.Generator] = ()) -> None:
        if not 1 <= len(branches) <= MAX_BRANCHES:
            raise ValueError(f"a loop takes 1..{MAX_BRANCHES} branches, got {len(branches)}")
        if pre is None and len(branches) > 1:
            raise ValueError("several branches need a pre segment that sets the mode")
        if mode.dtype != torch.int64 or clock.dtype != torch.int64:
            raise TypeError("mode and clock must be int64 tensors")
        lib = _library()
        segment_pool = torch.cuda.graph_pool_handle()
        self.pre = Segment(pre, segment_pool) if pre is not None else None
        self.branches = [Segment(fn, segment_pool) for fn in branches]
        self.post = Segment(post, segment_pool)
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        pool = torch.cuda.graph_pool_handle()
        with uncounted() as launched, torch.cuda.graph(self.graph, pool=pool):
            prologue()
            nodes = _kernel_nodes(lib, None, torch.cuda.current_stream())
            self._append_loop(lib, mode, clock, limit)
        self.prologue_launched = (*launched, nodes or 0)
        # The body's own kernels, every step: the WHILE setter, and the branch
        # setter where there is a pre segment.
        self.setters = (0,) * len(launched) + (1 + (self.pre is not None),)
        #: Whether the last count of :meth:`launches` holds every kernel node.
        self.counted = nodes is not None and all(
            s.counted for s in [self.pre, self.post, *self.branches] if s is not None)

    def _append_loop(self, lib, mode: torch.Tensor, clock: torch.Tensor, limit: int) -> None:
        stream = torch.cuda.current_stream()
        handle, body = ctypes.c_ulonglong(), ctypes.c_void_p()
        _check(lib.fdtpu_cond_begin_while(stream.cuda_stream, stream.device.index or 0,
                                          ctypes.byref(handle), ctypes.byref(body)),
               "the WHILE node")
        dep = ctypes.c_void_p()

        def child(graph: ctypes.c_void_p, after: ctypes.c_void_p, segment: Segment):
            node = ctypes.c_void_p()
            _check(lib.fdtpu_cond_add_child(graph, after, segment.raw, ctypes.byref(node)),
                   "a child-graph node")
            return node

        if self.pre is None:
            dep = child(body, dep, self.branches[0])
        else:
            dep = child(body, dep, self.pre)
            n = len(self.branches)
            handles = (ctypes.c_ulonglong * n)()
            for k in range(n):
                h = ctypes.c_ulonglong()
                _check(lib.fdtpu_cond_handle(body, ctypes.byref(h)), "an IF handle")
                handles[k] = h.value
            setter = ctypes.c_void_p()
            _check(lib.fdtpu_cond_add_branch_setter(body, dep, mode.data_ptr(), handles, n,
                                                    ctypes.byref(setter)), "the branch setter")
            dep = setter
            for k, segment in enumerate(self.branches):
                node, branch_body = ctypes.c_void_p(), ctypes.c_void_p()
                _check(lib.fdtpu_cond_add_if(body, dep, handles[k], ctypes.byref(node),
                                             ctypes.byref(branch_body)), "an IF node")
                child(branch_body, None, segment)
                dep = node
        dep = child(body, dep, self.post)
        last = ctypes.c_void_p()
        _check(lib.fdtpu_cond_add_while_setter(body, dep, clock.data_ptr(), limit, handle.value,
                                               ctypes.byref(last)), "the WHILE setter")

    def replay(self) -> None:
        self.graph.replay()

    def launches(self, replays: int, steps: int, runs: Sequence[int]) -> tuple[int, ...]:
        """The counted launches and then the kernel nodes of ``replays``
        replays that ran ``steps`` loop iterations in all, branch k
        ``runs[k]`` of them (the caller's device counts, read once)."""
        total = [replays * n for n in self.prologue_launched]
        every_step = [self.setters] + [s.launched for s in (self.pre, self.post) if s is not None]
        if self.pre is None:
            runs = [steps]
        for counts, n in ([(c, steps) for c in every_step]
                          + [(seg.launched, n) for seg, n in zip(self.branches, runs)]):
            total = [a + n * b for a, b in zip(total, counts)]
        return tuple(total)
