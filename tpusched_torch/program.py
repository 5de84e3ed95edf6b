"""A step as one program over static buffers: the port's counterpart of a
``jax.jit`` with its cache donated.

The reference builds each step of its serving engine, ``generate``'s and
``sample``'s scanned loops and its train steps as one compiled XLA
program. Run eagerly on
the card, the same step is a few hundred to a few thousand kernel
launches, each issued by the host, and the card waits for the host most
of the time. A :class:`Program` wraps a plain function, the body, that
reads its inputs from static buffers and returns its outputs; state the
body updates, such as a KV-cache arena, it writes in place.

On a CUDA device the body is captured once as a ``torch.cuda.CUDAGraph``:
warm-up calls on a side stream (they build the kernels, load their
libraries and set their attributes), then the capture on that stream.
Each call copies the new inputs into the buffers (through pinned host
memory, ``non_blocking``) and replays the graph. A body that cannot be
captured raises; nothing falls back. Programs that pass one memory pool
(``torch.cuda.graph_pool_handle()``) share it, and must then run one at
a time on one stream, as a serving engine's do.

Elsewhere (``graphed=False``: the CPU, or an engine whose collectives
stage through the host) each call runs the body on the same buffers, and
its output is copied into the static output that the first call made.

A body that advances state it reads again (a train step updating its
parameters, a sampling step drawing from a generator) is built with
``advances=True``: its first call's warm-up run IS that call's step, the
capture follows with no replay, and every later call replays. A
``torch.Generator`` the body draws from is passed in ``generators``: it is
registered with the graph before the capture, so each replay draws at the
generator's current offset and advances it, as the body called eagerly
would, instead of replaying one frozen draw.

The flash kernels' launch counters (``attention.FLASH_*_LAUNCHES``)
count the wrappers' Python calls, which a replay does not make. So a
program counts the launches its capture recorded, leaves the counters
as they were before its warm-up calls, and adds the recorded launches on
every replay: the counts stay those of the kernels that ran for the
program's results.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import attention

_COUNTERS = ("FLASH_FWD_LAUNCHES", "FLASH_BWD_DKDV_LAUNCHES",
             "FLASH_BWD_DQ_LAUNCHES")


def _counts() -> Tuple[int, ...]:
    return tuple(getattr(attention, n) for n in _COUNTERS)


def _set_counts(counts: Tuple[int, ...]) -> None:
    for name, c in zip(_COUNTERS, counts):
        setattr(attention, name, c)


def _copy_in(buf: torch.Tensor, value) -> None:
    """``value`` (a tensor, a numpy array or a Python number) into ``buf``.
    A host value bound for the card goes through pinned memory, copied
    without a wait; the caching host allocator keeps the pinned block until
    the copy has run."""
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.asarray(value))
    if tuple(value.shape) != tuple(buf.shape):
        raise ValueError(f"input of shape {tuple(value.shape)} for a "
                         f"buffer of shape {tuple(buf.shape)}")
    if buf.device.type == "cuda" and value.device.type == "cpu":
        value = value.to(buf.dtype).pin_memory()
    buf.copy_(value, non_blocking=True)


class Program:
    """``body`` over the static ``inputs`` (name -> buffer), captured as a
    CUDA graph when ``graphed`` (the buffers then lie on the card), else
    called as it is. The body returns one tensor, or None where it only
    writes in place. ``pool``: a graph memory pool shared with other
    programs. ``outputs`` holds the static output once the program has
    run, overwritten by every later call."""

    def __init__(self, body: Callable[[], Optional[torch.Tensor]],
                 inputs: Dict[str, torch.Tensor], *, graphed: bool,
                 pool=None, generators: Sequence[torch.Generator] = (),
                 advances: bool = False):
        self.body = body
        self.inputs = inputs
        self.graphed = graphed
        self.pool = pool
        self.generators = tuple(generators)
        self.advances = advances
        self.outputs: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._launches = (0,) * len(_COUNTERS)

    def capture(self) -> None:
        """Warm the body up on a side stream and capture it, once; a no-op
        when not ``graphed``. The warm-up calls run on the buffers as they
        are and write what the body writes: capture where those writes are
        the ones the next replay makes (the same inputs), or land where
        nothing reads them (an idle arena)."""
        if not self.graphed or self.graph is not None:
            return
        if self.advances:
            raise RuntimeError("a program that advances its state captures "
                               "at its first call, whose step the warm-up "
                               "runs")
        self._capture()

    def _capture(self) -> None:
        """The warm-up call and the capture, both on a side stream. An
        advancing program keeps the warm-up's launches counted and its
        output as the static output's value: that run was its first
        step."""
        before = _counts()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warm = self.body()
        ran = _counts()
        _set_counts(before)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        # no cyclic collection while capturing: one could destroy another
        # program's graph, which the capture refuses (torch.cuda.graph no
        # longer collects first)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                outputs = self.body()
        finally:
            if collecting:
                gc.enable()
        self._launches = tuple(a - b for a, b in zip(_counts(), before))
        if self.advances:
            _set_counts(ran)
            if outputs is not None:
                with torch.cuda.stream(side):   # after the warm-up's writes
                    outputs.copy_(warm)
        else:
            _set_counts(before)
        torch.cuda.current_stream().wait_stream(side)
        self.outputs, self.graph = outputs, graph

    def __call__(self, **values) -> Optional[torch.Tensor]:
        """Copy ``values`` (by input name) into the buffers, run, and return
        the static output."""
        for name, value in values.items():
            _copy_in(self.inputs[name], value)
        if not self.graphed:
            out = self.body()
            if self.outputs is None:
                self.outputs = out
            else:
                self.outputs.copy_(out)
            return self.outputs
        if self.graph is None:
            self._capture()
            if self.advances:
                return self.outputs
        self.graph.replay()
        _set_counts(tuple(c + n for c, n in zip(_counts(), self._launches)))
        return self.outputs
