"""Spans inside the port, on the profiler's clock.

A span records a name, a start and an end, the span it runs inside (its
parent) and attributes such as a segment's name. The spans of one public
call (`solver`, `solver_raw` or `solver_socp`, whichever is entered first)
form one problem: the root span `solve`, given the call's id, and under it
the phases `assembly`, `loop` and `finish`, which share their boundary
stamps, so that `solve` = `assembly` + `loop` + `finish` exactly. This
process keeps the spans of its last traced problem whole (`last_problem`),
with per-name totals and the change over the problem in every counter the
program keeps (`ops.graphs`'s and `ops.laplacian.CG_COUNTERS`); on a mesh
each rank keeps its own.

Stamps are `time.time_ns()`: CLOCK_REALTIME, the clock torch.profiler
(Kineto) stamps its host events with, so a span lines up with the
profiler's events with no conversion. That clock is not monotonic: where
the wall clock is stepped (not slewed) while a span is open, its length is
off by the step, and so are the readings that take a span's (`timed`:
`graphs.STATS.capture_seconds` and the history's `STEP_TAG` and `KKT_TAG`
step times).

Tracing is off unless the process starts with `DOTS_SOCP_TRACE=1`,
`enable()` was called, or a torch.profiler session is recording when a
public call begins (tested once, at entry). Off, a span site costs one test
of the module flag `ON`: no CUDA event, no profiler range, no allocation, no
synchronisation. On, each CUDA graph replay (`replay`) is bracketed by two
timing events, taken from a pool and recorded outside any capture, so its
`run` span carries its device seconds; on the CPU there are none. What a
problem keeps is put together when `last_problem()` reads it, outside any
call: one wait for its last replay, then the events' readings. A problem
not read before the next one begins gives its events back unread (its
device seconds stay None), so no call waits on an earlier one's events.
The spans are kept as columns the garbage collector does not track, so a
long solve's spans set off no full collection inside it.
`enable(annotate=True)` also opens a `torch.profiler.record_function`
range for every span, so a profiler trace shows the program's phases over
its kernels.

A span inside a captured segment runs only while the segment is captured
(and warmed up): a replay repeats the device work, not the host code.

    with trace.span("build_problem"):
        ...
    trace.last_problem()  # {"id", "spans", "totals", "counters"}
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

#: True while a traced problem is open: the one flag every span site tests.
ON = False

_WANT = os.environ.get("DOTS_SOCP_TRACE", "") == "1"
_ANNOTATE = False
_DEPTH = 0  # public calls open (a nested entry opens no second problem)
_CALLS = 0  # public calls entered in this process: the problems' ids
_OPEN = None  # the open problem (`_Problem`)
_LAST = None  # `last_problem()`
_SOURCES: list = []  # functions returning a flat dict of counters (`add_counters`)
_POOL: list = []  # free CUDA timing events


_NULL = contextlib.nullcontext()  # a span site's context while tracing is off


def enable(annotate: bool = False):
    """Trace every later public call; `annotate`: a profiler range per span."""
    global _WANT, _ANNOTATE
    _WANT, _ANNOTATE = True, bool(annotate)


def disable():
    """Trace no later call unless a profiler is recording (an open problem
    is traced to its end)."""
    global _WANT, _ANNOTATE
    _WANT, _ANNOTATE = False, False


def add_counters(read):
    """Take the change in `read()`'s counters (a flat dict of numbers) over
    every traced problem."""
    _SOURCES.append(read)


def _counters() -> dict:
    out = {}
    for read in _SOURCES:
        out.update(read())
    return out


def _profiler_on() -> bool:
    return bool(torch._C._autograd._profiler_enabled())


class _Problem:
    """The spans of one open problem, kept as columns (a span is its index)
    of numbers, strings and small dicts of them: objects the garbage
    collector does not track, so that tens of thousands of spans do not set
    off a full collection inside the solve."""

    def __init__(self, pid, annotate):
        self.id, self.annotate = pid, annotate
        self.names: list = []
        self.starts: list = []
        self.ends: list = []
        self.parents: list = []
        self.attrs: list = []
        self.device: dict = {}  # span -> device seconds of its replay
        self.phases: set = set()  # the spans that `phase` opened
        self.ranges: dict = {}  # span -> its open profiler range (annotate)
        self.stack: list = []  # open spans, outermost first
        self.pending = ([], [], [])  # the replays' spans, start and end events
        self.before = _counters()
        self.after = self.done = None

    def open(self, name, attrs, t, phase=False) -> int:
        i = len(self.names)
        self.names.append(name)
        self.starts.append(t)
        self.ends.append(None)
        self.parents.append(self.stack[-1] if self.stack else None)
        self.attrs.append(attrs)
        self.stack.append(i)
        if phase:
            self.phases.add(i)
        if self.annotate:  # after the stamp: the range lies inside the span
            rf = self.ranges[i] = torch.profiler.record_function(name)
            rf.__enter__()
        return i

    def close_to(self, depth) -> int:
        """Close the open spans from `depth` on, their profiler ranges
        first; the one stamp that ends them all."""
        top = self.stack[depth:]
        for i in reversed(top):
            rf = self.ranges.pop(i, None)
            if rf is not None:
                rf.__exit__(None, None, None)
        t = time.time_ns()
        for i in top:
            self.ends[i] = t
        del self.stack[depth:]
        return t

    def close(self, i) -> int:
        """Close the open span `i` and every span opened inside it; its end
        stamp."""
        return self.close_to(self.stack.index(i))

    def resolve(self):
        """The replays' device seconds from their events (which go back to
        the pool): one wait for the last replay, after which the others,
        which ran before it on its stream, are done."""
        spans, starts, ends = self.pending
        if ends:
            ends[-1].synchronize()
        for i, e0, e1 in zip(spans, starts, ends):
            if not e1.query():  # a replay on another stream
                e1.synchronize()
            self.device[i] = e0.elapsed_time(e1) / 1e3
        self.drop()

    def drop(self):
        """Give the replays' events back to the pool unread."""
        _, starts, ends = self.pending
        _POOL.extend(starts)
        _POOL.extend(ends)
        for column in self.pending:
            column.clear()

    def result(self) -> dict:
        if self.done is None:
            self.resolve()
            self.done = {
                "id": self.id,
                "spans": [{"name": n, "start_ns": t0, "end_ns": t1, "parent": p, "attrs": a,
                           "device_s": self.device.get(i)}
                          for i, (n, t0, t1, p, a) in enumerate(zip(
                              self.names, self.starts, self.ends, self.parents, self.attrs))],
                "totals": self.totals(),
                "counters": {k: v - self.before.get(k, 0) for k, v in self.after.items()},
            }
        return self.done

    def totals(self) -> dict:
        """Per name (and per `name.segment` for spans of a segment): count,
        host seconds, self seconds (less the children's), device seconds
        (None where no span of the name measured any)."""
        inner = [0] * len(self.names)
        for p, t0, t1 in zip(self.parents, self.starts, self.ends):
            if p is not None:
                inner[p] += t1 - t0
        totals = {}
        for i, (name, t0, t1, attrs) in enumerate(zip(self.names, self.starts, self.ends,
                                                      self.attrs)):
            keys = [name]
            if "segment" in attrs:
                keys.append(f"{name}.{attrs['segment']}")
            for key in keys:
                t = totals.setdefault(key, {"count": 0, "host_s": 0.0, "self_s": 0.0,
                                            "device_s": None})
                t["count"] += 1
                t["host_s"] += (t1 - t0) / 1e9
                t["self_s"] += (t1 - t0 - inner[i]) / 1e9
                if i in self.device:
                    t["device_s"] = (t["device_s"] or 0.0) + self.device[i]
        return totals


class _Timed:
    """A span's context: records the span while tracing is on, and times
    its extent either way (`seconds`)."""

    __slots__ = ("name", "attrs", "start", "end", "_span")

    def __init__(self, name, attrs):
        self.name, self.attrs, self._span = name, attrs, None

    def __enter__(self):
        self.start = time.time_ns()
        if ON:
            self._span = _OPEN.open(self.name, self.attrs, self.start)
        return self

    def __exit__(self, *exc):
        i = self._span
        if i is None:
            self.end = time.time_ns()
        else:  # a `phase` call may have closed it already
            end = _OPEN.ends[i]
            self.end = end if end is not None else _OPEN.close(i)
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def span(name: str, **attrs):
    """A span around the `with` block (nothing while tracing is off)."""
    return _Timed(name, attrs) if ON else _NULL


def timed(name: str, **attrs) -> _Timed:
    """`span`, timed also while tracing is off: after the block,
    `.seconds` is its extent (the one reading a caller's own timer takes)."""
    return _Timed(name, attrs)


def run(segment: str, how: str):
    """The `run` span of one segment run: `how` it ran ("replay", "capture"
    (captured, then replayed), "op_by_op" or "eager")."""
    return _Timed("run", {"segment": segment, "how": how}) if ON else _NULL


def replay(graph, device, outside):
    """`graph.replay()`; while tracing, between two timing events on
    `device`'s current stream, whose interval becomes the device seconds of
    the innermost open span. `outside`: the caller runs inside no segment,
    so no capture is open (the caller knows it without asking the device)."""
    if not (ON and outside):
        graph.replay()
        return
    stream = torch.cuda.current_stream(device)
    e0 = _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)
    e1 = _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)
    e0.record(stream)
    graph.replay()
    e1.record(stream)
    spans, starts, ends = _OPEN.pending
    spans.append(_OPEN.stack[-1])
    starts.append(e0)
    ends.append(e1)


def phase(*path: str):
    """Make the open phases `path`, from the root down (`phase("finish",
    "recover")`): those already open under the same names stay, the rest
    close, and the new ones open at the stamp that closed them. A phase
    stays open until another `phase` call closes it or the problem ends."""
    if not ON:
        return
    stack, keep = _OPEN.stack, 1
    while (keep <= len(path) and keep < len(stack) and stack[keep] in _OPEN.phases
           and _OPEN.names[stack[keep]] == path[keep - 1]):
        keep += 1
    t = _OPEN.close_to(keep)
    for name in path[keep - 1:]:
        _OPEN.open(name, {}, t, phase=True)


def note(**attrs):
    """Attributes of the open problem's root span (e.g. its iterations)."""
    if ON:
        _OPEN.attrs[0].update(attrs)


def problem(fn):
    """Make `fn` a public entry: its outermost call is one problem, traced
    when tracing is wanted or a profiler is recording at entry."""

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        global _DEPTH, _CALLS
        if _DEPTH:
            return fn(*args, **kwargs)
        _DEPTH, _CALLS = 1, _CALLS + 1
        try:
            if not (_WANT or _profiler_on()):
                return fn(*args, **kwargs)
            _begin(_CALLS)
            failed = True
            try:
                out = fn(*args, **kwargs)
                failed = False
                return out
            finally:
                _end(failed)
        finally:
            _DEPTH = 0

    return entry


def _begin(pid):
    global ON, _OPEN
    if _LAST is not None:
        _LAST.drop()  # unread: waiting for its events here would wait inside this call
    _OPEN = _Problem(pid, _ANNOTATE)
    t = time.time_ns()
    _OPEN.open("solve", {}, t)
    _OPEN.open("assembly", {}, t, phase=True)
    ON = True


def _end(failed):
    """Close the problem; what it keeps is put together when read
    (`last_problem`), outside any call."""
    global ON, _OPEN, _LAST
    p, ON, _OPEN = _OPEN, False, None
    p.close_to(0)
    if failed:  # the device may be in error: read no event
        for column in p.pending:
            column.clear()
        p.attrs[0]["failed"] = True
    p.after = _counters()
    _LAST = p


def last_problem():
    """The last traced problem of this process: {"id", "spans", "totals",
    "counters"}, or None. `spans` in the order they opened, each with
    `name`, `start_ns`, `end_ns`, `parent` (an index; None at the root),
    `attrs` and `device_s`; the root's attrs carry what the solve noted
    (`iterations`). The first read waits for the problem's last replay:
    read it outside any call that is being timed."""
    return None if _LAST is None else _LAST.result()
