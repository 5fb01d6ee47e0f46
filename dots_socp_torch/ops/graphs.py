"""CUDA graphs for the solver's loops, on one device and on a mesh: capture
once, replay.

The JAX package runs its loops on the device: `run_chunk` is one jitted
`lax.fori_loop` over the iterations (`dots_socp_tpu/solver/step.py:173-179`)
and the CG's inner loop a `lax.while_loop` (`ops/laplacian.py:930-955`), so
the host syncs only at KKT validations. PyTorch launches every op from the
host. On the card the port records a loop body's launches once as a CUDA
graph and replays it: one host call per replay, whatever the body launches.

A `Workspace` holds static buffers, a dict of tensors by name, and the
segments captured over them. A segment is a function of the buffers that
returns new values for some of them; `Workspace.run(name, fn)` writes those
values into the buffers in place:

* On a CUDA device the first run of a segment warms it up on a side stream
  (lazy initialisation: the kernel library, cuBLAS's handle, the window
  kernel's shared-memory grant) and drops that result, captures the
  segment into a CUDA graph in the workspace's private memory pool, and
  replays it; later runs replay. A capture that fails raises, and the
  buffers are left as they were: nothing falls back to eager. A segment
  that updates buffers in place (named in `Workspace(..., in_place=...)`:
  kernel K4's CG blocks) warms up on copies of the buffers.
* On the CPU it runs the segment eagerly and copies into the same
  buffers, so the CPU tests go through the same plumbing, aliasing
  included.

A graph replays the addresses it captured: the buffers and every tensor
the segment reads besides them (operator leaves). `cached` therefore keys
an object that owns a workspace by the identity of those tensors and keeps
them alive while it is cached; a new operator gets a new workspace.

The host counters that a segment ticks where it launches a kernel
(`register_counter`: kernel B1's launches, the CG's window matvecs) tick
once while it is captured, where nothing is launched; the capture's ticks
are taken back and added again at every replay, so each counts the
launches that ran.

`STATS` counts, in this process, the captures and the host seconds they
took (warm-up, capture and instantiation: the `capture` span's reading) and
the misses of `cached`: what a solve spends on its graphs besides replaying
them. `counters()` gives every counter here by name, which `utils.trace`
differences over each traced problem; while tracing is on, every segment
run is a `run` span, and every replay carries its device seconds.

Between replays the host reads what it must decide on with `read`: a copy
into pinned host memory and one event synchronisation, counted in
`HOST_READS`. A read runs on the host between segments, never inside one,
so it counts where it happens; nothing is taken back at a capture.

`eager()` turns all of this off for its extent: a segment's values replace
the dict's entries (no copy, no capture) and nothing is cached, which is
how PyTorch runs without graphs (the card tests and `chip_smoke.py` hold
the graphed loops against it). `uncaptured()` keeps the buffers and the
cache but runs every segment as on the CPU, op by op, on the card too: the
same loops' launches made from the host, which the card tests count
against the replays'.

On a mesh (`Workspace(..., mesh=...)`, one per rank) a segment holds the
mesh's collectives. Over nccl (one card per rank) they are captured with
the rest: the warm-up runs them on every rank, the capture records them
(`capture_error_mode="thread_local"`: ProcessGroupNCCL's watchdog thread
queries CUDA events meanwhile), and every replay runs them. A capture is
collective: every rank of the workspace's group (the CG's: its space
group; the iteration's: the world) captures the same segments in the same
order, and after each they agree on its outcome, so a capture that fails
on one rank raises on every rank. gloo's collectives cannot be captured:
a gloo mesh runs its workspace's segments op by op, as `uncaptured()`
does, on the card and on the CPU alike (`STATS.uncaptured_runs` counts
them). A host-side collective (`ops.collectives.space_any`,
`rank0_decides`, `object_from_rank0`) reads the host, so it raises inside
any segment (`host_side`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import operator

import torch
import torch.distributed as dist

from dots_socp_torch.utils import trace

#: Objects kept by `cached` (least recently used dropped first): a solve
#: holds its iteration's and its CG's.
MAX_CACHED = 4

_ENABLED = True
_CAPTURE = True
_CACHE: collections.OrderedDict = collections.OrderedDict()
_COUNTERS: list = []  # (read, write, name) of every registered host counter
_STAGING: dict = {}  # (device, shape, dtype) -> (pinned host tensor, event) of `read`
_SEGMENT = None  # the name of the segment being run, None between segments

#: Host reads of device values through `read` in this process.
HOST_READS = 0


@dataclasses.dataclass
class GraphStats:
    """Graph work in this process besides the replays."""

    captures: int = 0  # segments captured (`Workspace._capture`)
    capture_seconds: float = 0.0  # host seconds in those captures
    cache_misses: int = 0  # objects `cached` had to make
    uncaptured_runs: int = 0  # segment runs made op by op (the CPU, `uncaptured()`, gloo)

    def snapshot(self) -> dict:
        return dict(vars(self))

    def since(self, before: dict) -> dict:
        """What was counted after `before` (a `snapshot`)."""
        return {k: v - before[k] for k, v in vars(self).items()}


STATS = GraphStats()


def register_counter(read, write, name):
    """Count a host counter through replays: `read()` returns its value, a
    number or a dict of them (nested), and `write(value)` sets it; `name`
    names it in `counters()`."""
    _COUNTERS.append((read, write, name))


def _counter_values():
    return [read() for read, _, _ in _COUNTERS]


def _set_counters(values):
    for (_, write, _), value in zip(_COUNTERS, values):
        write(value)


def counters() -> dict:
    """Every counter of this module in this process, flat by name:
    `STATS`'s fields, the host reads and the registered counters (a dict's
    keys joined to the name with dots)."""
    out = {f"graphs.{k}": v for k, v in vars(STATS).items()}
    out["graphs.host_reads"] = HOST_READS

    def put(name, value):
        if isinstance(value, dict):
            for k, v in value.items():
                put(f"{name}.{k}", v)
        else:
            out[name] = value

    for read, _, name in _COUNTERS:
        put(name, read())
    return out


def _combine(a, b, op):
    """`op(a, b)` of two counter values, key by key in dicts (a key that one
    side lacks counts 0 there)."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: _combine(a.get(k, 0), b.get(k, 0), op) for k in a.keys() | b.keys()}
    return op(a, b)


def host_side(what: str):
    """Raise inside a segment: `what` reads a value on the host, which a
    segment's capture cannot hold and its replays would not repeat."""
    if _SEGMENT is not None:
        raise RuntimeError(f"{what} reads the host: it cannot run inside segment {_SEGMENT!r}")


@contextlib.contextmanager
def _in_segment(name):
    global _SEGMENT
    before, _SEGMENT = _SEGMENT, name
    try:
        yield
    finally:
        _SEGMENT = before


def _capturable(device, mesh) -> bool:
    """Whether segments on `device` (this rank's of `mesh`) can be CUDA
    graphs: on the card, with no mesh or over nccl."""
    return torch.device(device).type == "cuda" and (mesh is None or mesh.capturable)


def will_capture(device, mesh=None) -> bool:
    """Whether a segment on `device` (this rank's of `mesh`) runs as a CUDA
    graph replay here: `_capturable`, outside `eager()` and `uncaptured()`."""
    return _ENABLED and _CAPTURE and _capturable(device, mesh)


def mesh_key(mesh):
    """What a cached object on `mesh` is keyed by besides its tensors: the
    mesh's place and its process groups (None: one device)."""
    if mesh is None:
        return None
    return (mesh.time, mesh.space, mesh.time_rank, mesh.rank,
            *(id(g) for g in (mesh.group, mesh.time_group, mesh.world_group)))


def enabled() -> bool:
    """False inside `eager()`."""
    return _ENABLED


@contextlib.contextmanager
def eager():
    """Run every segment eagerly on fresh tensors: no static buffers, no
    graphs, no cache (the loops as they ran before graphs)."""
    global _ENABLED
    before = _ENABLED
    _ENABLED = False
    try:
        yield
    finally:
        _ENABLED = before


@contextlib.contextmanager
def uncaptured():
    """Run the segments into their buffers op by op, on the card too."""
    global _CAPTURE
    before = _CAPTURE
    _CAPTURE = False
    try:
        yield
    finally:
        _CAPTURE = before


def read(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host, a CPU tensor of its own: from a CUDA tensor one
    non-blocking copy into a pinned buffer and one event synchronisation
    (the host waits for the work before the copy, no more)."""
    global HOST_READS
    HOST_READS += 1
    with trace.span("read"):
        if t.device.type != "cuda":
            return t.detach().clone()
        key = (t.device, t.shape, t.dtype)
        staged = _STAGING.get(key)
        if staged is None:
            staged = _STAGING[key] = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True),
                                      torch.cuda.Event())
        host, event = staged
        host.copy_(t, non_blocking=True)
        event.record(torch.cuda.current_stream(t.device))
        event.synchronize()
        return host.clone()


def leaves(*trees) -> tuple:
    """The tensors in nested tuples (NamedTuples), lists and dicts."""
    found = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            found.append(t)
        elif isinstance(t, (tuple, list)):
            for u in t:
                walk(u)
        elif isinstance(t, dict):
            for u in t.values():
                walk(u)

    for tree in trees:
        walk(tree)
    return tuple(found)


def cached(key, make, keep=()):
    """The object cached under (`key`, the identities of `keep`), made by
    `make()` on a miss. `keep` holds every tensor the object's segments read
    besides its buffers; the cache keeps them alive, so an identity is never
    reused while its graphs may replay. Inside `eager()`: `make()`, uncached."""
    if not _ENABLED:
        return make()
    full = (key, tuple(id(t) for t in keep))
    hit = _CACHE.get(full)
    if hit is not None:
        _CACHE.move_to_end(full)
        return hit[0]
    STATS.cache_misses += 1
    obj = make()
    _CACHE[full] = (obj, keep)
    while len(_CACHE) > MAX_CACHED:
        _CACHE.popitem(last=False)
    return obj


def release():
    """Drop every cached object, its buffers and its graphs."""
    _CACHE.clear()


class Workspace:
    """Static buffers on one device and the segments captured over them;
    with `mesh`, this rank's of a mesh (captured over nccl, op by op over
    gloo). `group`: the process group whose ranks run the same segments in
    step (the collectives' widest group), which agree on every capture's
    outcome; None: no other rank."""

    def __init__(self, device, in_place=(), mesh=None, group=None):
        self.device = torch.device(device)
        self.in_place = frozenset(in_place)  # segments that also update buffers in place
        self.mesh, self.group = mesh, group
        self.captures = _capturable(self.device, mesh)
        self.bufs: dict = {}
        self._graphs: dict = {}
        self._pool = None

    def load(self, name, value):
        """Copy `value` into the buffer `name` (made on first use)."""
        if not _ENABLED:
            self.bufs[name] = value
            return
        buf = self.bufs.get(name)
        if buf is None:
            self.bufs[name] = value.detach().clone()
        elif buf is not value:
            _check_fits(name, buf, value)
            buf.copy_(value)

    def run(self, name, fn):
        """Write `fn(self.bufs)`'s values into the buffers (a segment of
        `in_place` may also update them in place and return them)."""
        if not _ENABLED:
            with trace.run(name, "eager"), _in_segment(name):
                self.bufs.update(fn(self.bufs))
            return
        for key, t in self.bufs.items():
            if t.device != self.device:
                raise ValueError(f"segment {name}: buffer {key} is on {t.device}, "
                                 f"the workspace on {self.device}")
        if not (self.captures and _CAPTURE):
            STATS.uncaptured_runs += 1
            with trace.run(name, "op_by_op"), _in_segment(name):
                self._write(fn(self.bufs))
            return
        captured = self._graphs.get(name)
        with trace.run(name, "replay" if captured else "capture"):
            if captured is None:
                with _in_segment(name):
                    captured = self._capture(name, fn)
            graph, ticks = captured
            trace.replay(graph, self.device, _SEGMENT is None)
        _set_counters([_combine(v, t, operator.add) for v, t in zip(_counter_values(), ticks)])

    def drop(self, segment, *buffers):
        """Forget the captured `segment` and the named buffers (made anew
        by the segment's next run, at their new shapes)."""
        self._graphs.pop(segment, None)
        for name in buffers:
            self.bufs.pop(name, None)

    def _write(self, values):
        for key, value in values.items():
            buf = self.bufs.get(key)
            if buf is None:  # the CPU's first run (a capture makes them first)
                self.bufs[key] = value.detach().clone()
            elif buf is not value:
                _check_fits(key, buf, value)
                buf.copy_(value)

    def _capture(self, name, fn):
        with trace.timed("capture", segment=name) as timed:
            captured = self._capture_graph(name, fn)
        STATS.captures += 1
        STATS.capture_seconds += timed.seconds
        return captured

    def _capture_graph(self, name, fn):
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm = ({k: v.clone() for k, v in self.bufs.items()} if name in self.in_place
                    else self.bufs)
            shapes = {k: (v.shape, v.dtype) for k, v in fn(warm).items()}
            del warm
        current.wait_stream(side)
        for key, (shape, dtype) in shapes.items():
            if key not in self.bufs:
                self.bufs[key] = torch.empty(shape, dtype=dtype, device=self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = _counter_values()
        graph = torch.cuda.CUDAGraph()
        # On a mesh, other threads (ProcessGroupNCCL's watchdog) query CUDA
        # events during the capture: only this thread's calls may not.
        mode = "global" if self.mesh is None else "thread_local"
        failed = None
        try:
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode=mode):
                self._write(fn(self.bufs))
            ticks = [_combine(a, b, operator.sub) for a, b in zip(_counter_values(), before)]
        except Exception as err:  # raised below, once every rank of a mesh knows
            failed = err
        finally:
            _set_counters(before)  # the capture launched nothing
        if self.group is not None:
            self._agree(name, failed)
        if failed is not None:
            raise failed
        self._graphs[name] = (graph, ticks)
        return graph, ticks

    def _agree(self, name, failed):
        """Every rank of `group` learns whether any rank's capture of `name`
        failed (one MAX all-reduce outside the capture); a rank whose own
        capture went through raises for the others."""
        flag = torch.tensor([0.0 if failed is None else 1.0], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        if failed is None and flag.item() > 0:
            raise RuntimeError(f"segment {name}: the capture failed on another rank of the mesh")


def _check_fits(name, buf, value):
    if buf.shape != value.shape or buf.dtype != value.dtype:
        raise ValueError(f"buffer {name}: {tuple(value.shape)} {value.dtype} does not fit "
                         f"{tuple(buf.shape)} {buf.dtype}")


trace.add_counters(counters)
