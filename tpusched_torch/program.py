"""A step as one program over static buffers: the port's counterpart of a
``jax.jit`` with its cache donated.

The reference builds each step of its serving engine, ``generate``'s and
``sample``'s scanned loops and its train steps as one compiled XLA
program, on one device or over a mesh. Run eagerly on the card, the same
step is a few hundred to a few thousand kernel launches, each issued by
the host, and the card waits for the host most of the time. A
:class:`Program` wraps a plain function, the body, that reads its inputs
from static buffers and returns its outputs; state the body updates, such
as a KV-cache arena, it writes in place.

On a CUDA device the body is captured once as a chain of
``torch.cuda.CUDAGraph`` segments broken at each collective: warm-up calls
on a side stream (they build the kernels, load their libraries, set their
attributes and run the collectives), then the capture on that stream.
Each collective the body makes through :mod:`.mesh` (``all_reduce``,
``all_gather``, ``broadcast``, the ring hop ``shift`` and the hand-offs
``send``, ``recv`` and a send's ``wait``) ends the segment being
captured, is kept as a break (the ``torch.distributed`` call, its tensors
and its arguments), and begins the next segment; a body with no
collective is one segment. No collective runs during the capture: every
rank records the same breaks without a message, so the ranks stay in
step. A train step's backward reaches the hook from autograd's device
thread, so a segment the main thread began may end there and the next
begin there: every segment is captured in CUDA's relaxed mode, the one in
which a capture may end on another thread than the one that began it.
Each call copies the new inputs into the buffers (through pinned host
memory, ``non_blocking``), replays segment 0, runs break 0 on the same
tensors, replays segment 1, and so on, the breaks in the body's order. No
collective is ever inside a graph, so the chain holds under gloo, whose
collectives stage through the host, as under NCCL. A body that cannot be
captured raises, and under gloo so does a collective that bypasses the
mesh during a capture (the capture stream refuses its host copy's wait,
in any mode); nothing falls back. All segments of a program share one
memory pool, and programs that pass one pool
(``torch.cuda.graph_pool_handle()``) share it too, and must then run one
at a time on one stream, as a serving engine's do.

Elsewhere (``graphed=False``: the CPU) each call runs the body on the same
buffers, its collectives run where it makes them, and its output is
copied into the static output that the first call made.

A body that advances state it reads again (a train step updating its
parameters, a sampling step drawing from a generator) is built with
``advances=True``: its first call's warm-up run IS that call's step, the
capture follows with no replay, and every later call replays. A
``torch.Generator`` the body draws from is passed in ``generators``: it is
registered with every segment before its capture (a segment that does not
draw advances it by nothing), so each replay draws at the generator's
current offset and advances it, as the body called eagerly would, instead
of replaying one frozen draw.

The kernels' launch counters (``attention.FLASH_*_LAUNCHES`` and
``attention.DECODE_ATTN_LAUNCHES``) count the wrappers' Python calls,
which a replay does not make. So a program counts the launches its
capture recorded, over all its segments, leaves the counters as they were
before its warm-up calls, and adds the recorded launches on every replay:
the counts stay those of the kernels that ran for the program's
results.

A program counts its ``captures`` and its ``replays``: the calls that ran
its step without capturing it (replaying its graphs, or where it is not
graphed calling its body), so an advancing program's first call counts a
capture and no replay. Its calls, warm-up and capture are spans of
:mod:`.tracing` (``program.stage``, ``program.replay``,
``program.warmup``, ``program.capture``, labelled with its name); the
device-timed phases its capture records fire at every replay, which arms
them to be read.
"""
from __future__ import annotations

import gc
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import attention, mesh, tracing

_COUNTERS = ("FLASH_FWD_LAUNCHES", "FLASH_BWD_DKDV_LAUNCHES",
             "FLASH_BWD_DQ_LAUNCHES", "DECODE_ATTN_LAUNCHES")


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


class _Cuda:
    """The CUDA calls a capture makes outside its graphs, in one place: the
    seam through which a CPU test stands a recorder in for the graphs, the
    side stream and the capture calls. A graph is used through
    ``register_generator_state``, ``capture_begin``, ``capture_end``,
    ``pool`` and ``replay``."""

    @staticmethod
    def side_stream():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        return side

    @staticmethod
    def on(stream):
        return torch.cuda.stream(stream)

    @staticmethod
    def prepare() -> None:
        """What ``torch.cuda.graph`` does before its capture."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    @staticmethod
    def graph():
        return torch.cuda.CUDAGraph()

    @staticmethod
    def join(stream) -> None:
        torch.cuda.current_stream().wait_stream(stream)


_cuda = _Cuda()


class _Chain:
    """A program's capture in progress, on the capture stream: the segments
    captured so far, the last one open, and the breaks between them.
    :func:`mesh.capturing` hands it each collective the body makes
    (:meth:`cut`). Every segment after the first captures into the first
    one's pool when the program has none of its own."""

    def __init__(self, name: str, pool, generators):
        self.name = name
        self.pool = pool
        self.generators = generators
        self.segments: List = []
        self.breaks: List[mesh.Collective] = []
        self.open = False
        self._begin()

    def _begin(self) -> None:
        if self.pool is None and self.segments:
            self.pool = self.segments[0].pool()
        graph = _cuda.graph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        # relaxed: a cut in a backward ends this segment on autograd's
        # device thread, which CUDA refuses in the global mode
        graph.capture_begin(*(() if self.pool is None else (self.pool,)),
                            capture_error_mode="relaxed")
        self.segments.append(graph)
        self.open = True

    def end(self) -> None:
        """End the open segment. One that follows a break may rightly hold
        no kernel (an f32 sum's result passed on as it is, to the next
        collective or as the output), so CUDA's warning of an empty graph
        is silenced there only: an empty first or only segment still warns,
        since there it means work the capture did not record."""
        if self.open:
            self.open = False
            with warnings.catch_warnings():
                if self.breaks:
                    warnings.filterwarnings("ignore",
                                            "The CUDA Graph is empty")
                self.segments[-1].capture_end()

    def cut(self, collective: "mesh.Collective") -> None:
        """End the open segment at ``collective``, keep it as the next
        break (it does not run now) and begin the next segment."""
        self.end()
        self.breaks.append(collective)
        self._begin()


class Program:
    """``body`` over the static ``inputs`` (name -> buffer), captured as a
    chain of CUDA graphs broken at its collectives when ``graphed`` (the
    buffers then lie on the card), else called as it is. The body returns
    one tensor, or None where it only writes in place. ``pool``: a graph
    memory pool shared with other programs. ``name``, the body's qualified
    name, names the program in errors. ``outputs`` holds the static output
    once the program has run, overwritten by every later call;
    ``segments`` the captured graphs, ``breaks`` the collectives between
    them (``len(breaks) == len(segments) - 1``), ``warmup_collectives``
    the collectives its warm-up call ran (a capture that recorded them all
    has one segment more), ``breaks_run`` the breaks its replays have
    run, summed over calls, and ``replays`` and ``captures`` its calls
    that ran the step without capturing it and its captures."""

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
        self.name = getattr(body, "__qualname__", repr(body))
        self.outputs: Optional[torch.Tensor] = None
        self.segments: List = []
        self.breaks: List[mesh.Collective] = []
        self.warmup_collectives = 0
        self.breaks_run = 0
        self.replays = 0
        self.captures = 0
        self._launches = (0,) * len(_COUNTERS)
        self._timed = None
        tracing.track(self)

    @property
    def graph(self):
        """The first segment once captured, else None."""
        return self.segments[0] if self.segments else None

    def capture(self) -> None:
        """Warm the body up on a side stream and capture it, once; a no-op
        when not ``graphed``. The warm-up calls run on the buffers as they
        are and write what the body writes: capture where those writes are
        the ones the next replay makes (the same inputs), or land where
        nothing reads them (an idle arena)."""
        if not self.graphed or self.segments:
            return
        if self.advances:
            raise RuntimeError("a program that advances its state captures "
                               "at its first call, whose step the warm-up "
                               "runs")
        self._capture()

    def _capture(self) -> None:
        """The warm-up call and the chain's capture, both on a side stream.
        An advancing program keeps the warm-up's launches counted and its
        output as the static output's value: that run was its first
        step."""
        before, collectives = _counts(), mesh.COLLECTIVES_RUN
        side = _cuda.side_stream()
        sid = tracing.begin("program.warmup", label=self.name)
        try:
            with _cuda.on(side):
                warm = self.body()
        finally:
            tracing.end(sid)
        ran = _counts()
        self.warmup_collectives = mesh.COLLECTIVES_RUN - collectives
        _set_counts(before)
        # no cyclic collection while capturing (autograd's thread
        # included: the switch is the interpreter's): one could destroy
        # another program's graph in the middle of this capture
        collecting = gc.isenabled()
        gc.disable()
        sid = tracing.begin("program.capture", label=self.name)
        try:
            _cuda.prepare()
            with _cuda.on(side), tracing.capture() as timed:
                chain = _Chain(self.name, self.pool, self.generators)
                try:
                    with mesh.capturing(chain):
                        outputs = self.body()
                finally:
                    chain.end()
        finally:
            tracing.end(sid)
            if collecting:
                gc.enable()
        self._launches = tuple(a - b for a, b in zip(_counts(), before))
        if self.advances:
            _set_counts(ran)
            if outputs is not None:
                with _cuda.on(side):   # after the warm-up's writes
                    outputs.copy_(warm)
        else:
            _set_counts(before)
        _cuda.join(side)
        self.outputs = outputs
        self.segments, self.breaks = chain.segments, chain.breaks
        self.captures += 1
        self._timed = tracing.Timed(timed) if timed else None

    def __call__(self, **values) -> Optional[torch.Tensor]:
        """Copy ``values`` (by input name) into the buffers, run, and return
        the static output."""
        sid = tracing.begin("program.stage", label=self.name)
        try:
            for name, value in values.items():
                _copy_in(self.inputs[name], value)
            if sid >= 0:
                tracing.note(sid, 0, sum(self.inputs[n].nbytes
                                         for n in values))
        finally:
            tracing.end(sid)
        if self.graphed and not self.segments:
            self._capture()
            if self.advances:
                return self.outputs
        sid = tracing.begin("program.replay", label=self.name)
        try:
            self._replay()
        finally:
            tracing.end(sid)
        return self.outputs

    def _replay(self) -> None:
        """The step: the body's call where the program is not graphed, else
        its segments replayed with the breaks between them."""
        if not self.graphed:
            out = self.body()
            if self.outputs is None:
                self.outputs = out
            else:
                self.outputs.copy_(out)
            self.replays += 1
            return
        if self._timed is not None:
            tracing.launching(self._timed)
        self.segments[0].replay()
        for brk, segment in zip(self.breaks, self.segments[1:]):
            brk()
            segment.replay()
        self.breaks_run += len(self.breaks)
        self.replays += 1
        _set_counts(tuple(c + n for c, n in zip(_counts(), self._launches)))
        if self._timed is not None:
            tracing.replayed(self._timed)
