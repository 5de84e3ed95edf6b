"""Spans and counters at the port's layer boundaries, kept in memory.

A span is a name, a start and an end on the host clock
(``time.perf_counter_ns()``), the span that was open when it began (its
parent), an optional label (a program's name) and up to four integer
attributes, named per span in :data:`ATTRS`. Spans of one request share
its ``rid``; spans of one tick lie inside its ``serve.tick``.

- The serving engine (``serve.ServeEngine``): ``serve.tick`` (the whole
  tick), ``serve.queued`` (a request from ``submit`` to its admission),
  ``serve.admit`` (one slot prefill and its first token's draw),
  ``serve.sample`` (tokens read back to the host and drawn) and
  ``serve.book`` (the per-slot booking). The decode program's call is its
  own ``program.stage`` and ``program.replay`` inside the tick.
- A program (``program.Program``): ``program.stage`` (its inputs copied
  into its buffers), ``program.replay`` (its graphs replayed with the
  breaks between them; where it is not graphed, its body's call),
  ``program.warmup`` and ``program.capture``.
- A train step (``workload``): ``train.step`` and the phases
  ``train.forward``, ``train.backward`` and ``train.optimizer``, timed on
  the device (:func:`device_begin`).
- ``python.gc``: each garbage collection, with its generation.

Spans live in a ring of :data:`RING` preallocated records; when it is
full the oldest is overwritten and counted as dropped. :func:`spans`
returns the finished ones as plain dicts. Nothing is exported or written.
Closing a span closes any span left open inside it, so the outermost
spans (a tick, a train step, a program's call) close in ``finally``: an
exception leaves no span open.

While a ``torch.profiler`` runs, each host span is also entered as a
``torch.profiler.record_function`` of its name, so the port's spans sit in
the profiler's trace on the device's clock. Two spans are not: ``serve.
queued`` (written when it ends) and ``python.gc`` (written from inside the
collector). With no profiler running a span costs two clock reads and
writes into its record; nothing is formatted.

A device-timed phase (:func:`device_begin`) on the card records two timing
events on the current stream. Inside a program's capture they become
event nodes of its graph (``external=True``), kept as the program's
:class:`Timed`, so every replay records them again: :func:`replayed` arms
them after each replay, and their elapsed time is read without a wait at
the step's next call (:func:`poll`), at :func:`spans`, or just before the
program's next launch (:func:`launching`), which would record them anew.
A phase whose events have not completed by then is not waited for: it is
counted as ``device_unread`` and written as a span with ``unread`` 1 and
no device time. So a program replayed again before its last replay has
run on the card, as the accumulation step's micro-step program is within
one step, has its phases read for its last replay only. A device-timed
span's start and end are the host times its work was issued (the
arming); its ``device_ns`` is the time on the card. Elsewhere the phase is
an ordinary host span.

Counters (:func:`counters`) report the recorder's own and read the port's
existing ones where they live: ``attention.FLASH_*_LAUNCHES``,
``attention.DECODE_ATTN_LAUNCHES``, ``mesh.COLLECTIVES_RUN`` and each
program's ``replays``, ``captures`` and ``breaks_run``.

One switch, :func:`enable`, on by default. The recorder expects its host
spans from one thread; a collection on another thread only adds its
``python.gc`` record.
"""
from __future__ import annotations

import contextlib
import gc
import time
import weakref
from array import array
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

RING = 1 << 15

ATTRS: Dict[str, tuple] = {
    "serve.tick": ("tick", "active"),
    "serve.queued": ("rid",),
    "serve.admit": ("rid", "slot", "bucket", "true_len"),
    "serve.book": ("finished",),
    "program.stage": ("bytes",),
    "train.step": ("step",),
    "train.forward": ("step", "unread"),
    "train.backward": ("step", "unread"),
    "train.optimizer": ("step", "unread"),
    "python.gc": ("generation",),
}

# a record's integers, _W to a record in one int64 array (which the
# garbage collector does not traverse): id, start_ns, end_ns (0 while
# open), parent id, attributes a-d, device_ns (-1: a host span); its name
# and label are in two lists beside it
_ID, _T0, _T1, _PARENT, _A, _DEV, _W = 0, 1, 2, 3, 4, 8, 9
_EMPTY = (-1, 0, 0, -1, 0, 0, 0, 0, -1)

_clock = time.perf_counter_ns


class Timed:
    """A program's device-timed phases: (name, start event, end event),
    armed after each replay until read."""
    __slots__ = ("pairs", "armed", "parent", "step", "at")

    def __init__(self, pairs):
        self.pairs = pairs
        self.armed = False
        self.parent = -1
        self.step = 0
        self.at = 0


class Recorder:
    """The ring, the open spans, the device phases awaiting a read and the
    counters. The module's functions act on one instance."""

    def __init__(self, size: int = RING):
        self.size = size
        self.on = True
        self.ints = array("q", _EMPTY) * size
        self.names: List[Optional[str]] = [None] * size
        self.labels: List[Optional[str]] = [None] * size
        self.next = 0
        self.dropped = 0
        self.device_unread = 0
        self.stack: List[int] = []
        self.annotations: list = []
        self.armed: List[Timed] = []
        self.collecting: Optional[list] = None
        self.gc_start = 0

    # -- host spans -----------------------------------------------------

    def _slot(self, name: str, label, parent: int, a: int, b: int, c: int,
              d: int) -> int:
        """The next record, written but for its times; returns the index
        of its integers."""
        sid = self.next
        self.next = sid + 1
        i = sid % self.size
        k, r = i * _W, self.ints
        if r[k] >= 0:
            self.dropped += 1
        r[k], r[k + 2], r[k + 3] = sid, 0, parent
        r[k + 4], r[k + 5], r[k + 6], r[k + 7], r[k + 8] = a, b, c, d, -1
        self.names[i], self.labels[i] = name, label
        return k

    def begin(self, name: str, a: int = 0, b: int = 0, c: int = 0,
              d: int = 0, label: Optional[str] = None) -> int:
        """Open span ``name`` inside the innermost open one; returns its id
        (-1 when off) for :meth:`end`."""
        if not self.on:
            return -1
        stack = self.stack
        k = self._slot(name, label, stack[-1] if stack else -1, a, b, c, d)
        sid = self.ints[k]
        stack.append(sid)
        if _profiler._is_profiler_enabled:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self.annotations.append(rf)
        else:
            self.annotations.append(None)
        self.ints[k + _T0] = _clock()
        return sid

    def end(self, sid: int) -> None:
        """Close span ``sid`` and any span left open inside it."""
        if sid < 0:
            return
        t = _clock()
        stack, annotations = self.stack, self.annotations
        while stack:
            top = stack.pop()
            rf = annotations.pop()
            if rf is not None:
                rf.__exit__(None, None, None)
            if top == sid:
                break
        k = sid % self.size * _W
        if self.ints[k] == sid:
            self.ints[k + _T1] = t

    def note(self, sid: int, i: int, value: int) -> None:
        """Set attribute ``i`` (0-3) of span ``sid``."""
        if sid >= 0:
            k = sid % self.size * _W
            if self.ints[k] == sid:
                self.ints[k + _A + i] = value

    def record(self, name: str, start_ns: int, end_ns: int, a: int = 0,
               b: int = 0, c: int = 0, d: int = 0) -> None:
        """A finished span with no parent, written at its end (a request's
        wait, which spans ticks)."""
        if self.on:
            k = self._slot(name, None, -1, a, b, c, d)
            self.ints[k + _T0], self.ints[k + _T1] = start_ns, end_ns

    def _gc(self, phase: str, info: dict) -> None:
        if not self.on:
            return
        if phase == "start":
            self.gc_start = _clock()
        elif self.gc_start:
            k = self._slot("python.gc", None,
                           self.stack[-1] if self.stack else -1,
                           info.get("generation", -1), 0, 0, 0)
            self.ints[k + _T0], self.ints[k + _T1] = self.gc_start, _clock()
            self.gc_start = 0

    # -- device-timed phases --------------------------------------------

    def device_begin(self, name: str, like: torch.Tensor):
        """Begin phase ``name`` of the work on ``like``'s device: two
        timing events on the card, a host span elsewhere."""
        if not self.on:
            return None
        if like.device.type != "cuda":
            return self.begin(name, self._step())
        start = torch.cuda.Event(enable_timing=True,
                                 external=self.collecting is not None)
        start.record()
        return name, start

    def device_end(self, handle) -> None:
        if handle is None:
            return
        if isinstance(handle, int):
            self.end(handle)
            return
        name, start = handle
        end = torch.cuda.Event(enable_timing=True,
                               external=self.collecting is not None)
        end.record()
        if self.collecting is not None:
            self.collecting.append((name, start, end))
        else:
            self._arm(Timed([(name, start, end)]))

    @contextlib.contextmanager
    def capture(self):
        """Collect the phases a program's capture records, which fire at
        each replay (:meth:`replayed`)."""
        self.collecting = pairs = []
        try:
            yield pairs
        finally:
            self.collecting = None

    def launching(self, timed: Timed) -> None:
        """Before a replay of a program whose capture recorded ``timed``,
        which records its events anew: the last replay's phases, if still
        armed, read or counted unread."""
        if timed.armed:
            self._read(timed, skip=True)
            timed.armed = False
            self.armed.remove(timed)

    def replayed(self, timed: Timed) -> None:
        """After that replay: its phases armed, to be read."""
        self._arm(timed)

    def _step(self) -> int:
        """The step count of the innermost open ``train.step``, else 0."""
        for sid in reversed(self.stack):
            i = sid % self.size
            if self.ints[i * _W] == sid and self.names[i] == "train.step":
                return self.ints[i * _W + _A]
        return 0

    def _stamp(self, timed: Timed) -> None:
        timed.parent = self.stack[-1] if self.stack else -1
        timed.step = self._step()
        timed.at = _clock()

    def _arm(self, timed: Timed) -> None:
        if len(self.armed) >= 64:
            self.poll()
        timed.armed = True
        self.armed.append(timed)
        self._stamp(timed)

    def _read(self, timed: Timed, skip: bool) -> bool:
        """Record ``timed``'s phases if its events have completed; else,
        with ``skip``, count them unread and record them with ``unread``
        1 and no device time. Never waits. True once done with it."""
        done = all(e.query() for _, _, e in timed.pairs)
        if not done:
            if not skip:
                return False
            self.device_unread += len(timed.pairs)
        if self.on:
            for name, start, end in timed.pairs:
                k = self._slot(name, None, timed.parent, timed.step,
                               0 if done else 1, 0, 0)
                self.ints[k + _T0] = self.ints[k + _T1] = timed.at
                if done:
                    self.ints[k + _DEV] = round(start.elapsed_time(end)
                                                * 1e6)
        return True

    def poll(self, skip: bool = True) -> None:
        """Read every armed phase that has completed; the others are
        counted unread with ``skip`` (the step's next call), else kept
        (a collection)."""
        keep = []
        for timed in self.armed:
            if self._read(timed, skip):
                timed.armed = False
            else:
                keep.append(timed)
        self.armed = keep

    # -- reading --------------------------------------------------------

    def spans(self) -> List[dict]:
        """The finished spans in the order their records were written, as
        plain dicts: ``id``,
        ``name``, ``label``, ``start_ns``, ``end_ns``, ``parent``,
        ``attrs`` (by :data:`ATTRS`' names) and ``device_ns`` (None for a
        host span). Phases that have completed on the card are read
        first."""
        self.poll(skip=False)
        out = []
        lo = max(0, self.next - self.size)
        for sid in range(lo, self.next):
            i = sid % self.size
            r = self.ints[i * _W:(i + 1) * _W]
            if r[_ID] != sid or r[_T1] == 0:
                continue
            names = ATTRS.get(self.names[i], ())
            out.append({"id": sid, "name": self.names[i],
                        "label": self.labels[i], "start_ns": r[_T0],
                        "end_ns": r[_T1], "parent": r[_PARENT],
                        "attrs": dict(zip(names, r[_A:_A + len(names)])),
                        "device_ns": None if r[_DEV] < 0 else r[_DEV]})
        return out

    def reset(self) -> None:
        """Forget every span and the recorder's counters."""
        self.ints = array("q", _EMPTY) * self.size
        self.next = self.dropped = self.device_unread = self.gc_start = 0
        self.stack.clear()
        self.annotations.clear()
        for timed in self.armed:
            timed.armed = False
        self.armed = []


_rec = Recorder()
_programs: "weakref.WeakSet" = weakref.WeakSet()

begin, end, note, record = _rec.begin, _rec.end, _rec.note, _rec.record
device_begin, device_end = _rec.device_begin, _rec.device_end
capture, launching, replayed = _rec.capture, _rec.launching, _rec.replayed
poll, spans, reset = _rec.poll, _rec.spans, _rec.reset
now = _clock


def enable(on: bool) -> None:
    """Record spans (the default) or not. Counters count either way."""
    _rec.on = bool(on)
    if on and _rec._gc not in gc.callbacks:
        gc.callbacks.append(_rec._gc)
    elif not on and _rec._gc in gc.callbacks:
        gc.callbacks.remove(_rec._gc)


def track(program) -> None:
    """Count ``program`` in :func:`counters` while it lives."""
    _programs.add(program)


def counters() -> dict:
    """The recorder's counters, the flash kernels' and K4's launches, the
    collectives run, and per program name (summed over the live programs
    of that name) its replays, captures and breaks run."""
    from . import attention, mesh
    out = {"spans_dropped": _rec.dropped,
           "device_unread": _rec.device_unread,
           "collectives_run": mesh.COLLECTIVES_RUN,
           "flash_fwd_launches": attention.FLASH_FWD_LAUNCHES,
           "flash_bwd_dkdv_launches": attention.FLASH_BWD_DKDV_LAUNCHES,
           "flash_bwd_dq_launches": attention.FLASH_BWD_DQ_LAUNCHES,
           "decode_attn_launches": attention.DECODE_ATTN_LAUNCHES}
    programs: Dict[str, Dict[str, int]] = {}
    for p in list(_programs):
        c = programs.setdefault(p.name, {"replays": 0, "captures": 0,
                                         "breaks_run": 0})
        c["replays"] += p.replays
        c["captures"] += p.captures
        c["breaks_run"] += p.breaks_run
    out["programs"] = programs
    return out


enable(True)
