"""The port's own spans and counters: what the host did, and when, at the
layer boundaries of serving, the LM loop and meshing.

A span records its name, its start and end on the host clock
(`time.perf_counter_ns`), its parent (the span open on the same thread when
it began: each thread keeps its own stack, so the serving worker and the
shard threads of `parallel/sharding.py` never mix), a group shared by the
spans of one request or batch (a child takes its parent's), and a few
integer or string attributes. Spans go to a bounded ring in host memory.
No span synchronizes the device: a span is host time, and the device's
time comes from the `torch.profiler` trace, on the clock `clock_offset_ns`
maps these timestamps to (profiler time = perf_counter_ns + offset).

Tracing is on while a `torch.profiler` session is active, or where `force`
says so. A session starts at the first call that finds tracing on after one
that found it off: the ring and the device counters are emptied and the
clock offset is read. While tracing is off, `span` returns one shared no-op
context manager and nothing else happens: no device operation, no
synchronize, no allocation.

Device counters (`add`) accumulate on the device without a read, only while
tracing is on, and are read once by `counters`. Host counters (`count`),
such as the kernels' launch counts, are always on.

Spans and counters (attributes), and the metric of `benchmark/metrics/`
that reads each:
* `serve.queue` (fruit, batch): a request, from the `submit()` that stamped
  it to the worker taking it into a batch; `serve.queue_wait_ms.p95`.
* `serve.batch` (batch, lanes, width): a whole batch, the worker's call of
  `CompletionServer._serve`; `serve.solve` (batch): its solve.
  `serve.host_ms_per_batch` reads the one less the other.
* `lm.solve` (phase: coarse, fine, main, polish or rescue; width): one LM
  loop. `lm.iteration` (active: the lanes neither done nor failed on entry;
  graph: 1 where the iteration's own code replayed as CUDA graphs, else 0):
  an iteration up to the return of its flag read. `lm.readback`: the flag
  read, the host's wait for the device. `lm.enqueue_ms_per_iter`,
  `lm.readback_ms_per_iter`, `lm.active_lane_share` and `lm.graph_share`
  read the iterations of every phase but the rescue. The host counter
  `graph_captures` of `optim/lm.py` counts the iterations' keys captured.
* `lm.rescue`: the selective rescue of `warmstart_solve`, whose loops take
  phase `rescue`.
* `mesh.decode` (codes, points: the grid's, chunks: the decode's launches
  of B4 on the card): `MeshExtractor.decode_grids`, its enqueue.
* `mesh.host` (fruits, threads: the native pool's threads that meshed the
  batch, one a fruit up to the process's CPUs; 1 for one fruit):
  `MeshExtractor.meshes_from_grids`; `mesh.readback`: inside it, the grids'
  copy to the host, the wait for the decode included.
  `mesh.readback_ms_per_fruit` reads the one, `mesh.iso_ms_per_fruit` the
  other less it.
* `render.band_rows`, a device counter: the band rows of every fused render
  call on the card; `render.b2_band_roofline`.
* `render.fwd_rows` and `render.rows`, device counters: the samples B2's
  forward runs the decoder on (in radius, on a valid ray, of an active
  lane) and every sample of the active lanes, over the same calls;
  `render.fwd_row_share`.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

RING = 1 << 17   # spans kept; a 51-s served window records about 12k


class Span(NamedTuple):
    name: str
    t0: int                  # perf_counter_ns
    t1: int
    sid: int
    parent: Optional[int]    # sid of the enclosing span on the same thread
    group: Optional[int]     # shared by the spans of one request or batch
    thread: int
    attrs: dict


_ring: "collections.deque[Span]" = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_forced: Optional[bool] = None
_session = False
_offset_ns = 0
_device: Dict[tuple, torch.Tensor] = {}


def _profiling() -> bool:
    """Whether a torch.profiler session is active: the flag torch keeps for
    fast checks (the one line a torch upgrade may have to change)."""
    return _profiler._is_profiler_enabled


def enabled() -> bool:
    """Whether tracing is on (a profiler session is active, or `force`)."""
    on = _profiling() if _forced is None else _forced
    if on != _session:
        _switch(on)
    return on


def _switch(on: bool) -> None:
    global _session, _offset_ns
    with _lock:
        if on == _session:
            return
        if on:
            _ring.clear()
            _device.clear()
            _offset_ns = time.time_ns() - time.perf_counter_ns()
        _session = on


def force(on: Optional[bool]) -> None:
    """Tracing on or off whatever the profiler does; None: follow the
    profiler again. For tests and for measuring what tracing costs."""
    global _forced
    _forced = None if on is None else bool(on)
    enabled()


def clock_offset_ns() -> int:
    """The profiler's clock (epoch ns) less `perf_counter_ns`, read when the
    session started."""
    return _offset_ns


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _Noop()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Open:
    __slots__ = ("name", "group", "attrs", "sid", "parent", "t0")

    def __init__(self, name: str, group: Optional[int], attrs: dict):
        self.name, self.group, self.attrs = name, group, attrs

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.parent = top.sid if top is not None else None
        if self.group is None and top is not None:
            self.group = top.group
        self.sid = next(_ids)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack().pop()
        _ring.append(Span(self.name, self.t0, t1, self.sid, self.parent, self.group,
                          threading.get_ident(), self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Attributes known only once the span is open."""
        self.attrs.update(attrs)


def span(name: str, group: Optional[int] = None, **attrs):
    """A context manager that records the block as span `name` while
    tracing is on, and the shared no-op otherwise."""
    if not enabled():
        return _NOOP
    return _Open(name, group, attrs)


def record(name: str, t0_ns: int, t1_ns: int, group: Optional[int] = None, **attrs) -> None:
    """A span the caller timed itself (perf_counter_ns), under the span open
    on this thread; only while tracing is on."""
    if not enabled():
        return
    stack = _stack()
    parent = stack[-1].sid if stack else None
    _ring.append(Span(name, int(t0_ns), int(t1_ns), next(_ids), parent, group,
                      threading.get_ident(), attrs))


def tag(name: str, **attrs) -> None:
    """Attributes set on the innermost span `name` open on this thread, by
    code that runs inside it; only while tracing is on."""
    if not enabled():
        return
    for s in reversed(_stack()):
        if s.name == name:
            s.attrs.update(attrs)
            return


def inside(name: str) -> bool:
    """Whether a span `name` is open on this thread."""
    return any(s.name == name for s in _stack())


def spans() -> List[Span]:
    """The session's spans, oldest first (at most RING)."""
    return list(_ring)


def count(ns: dict, name: str, n: int = 1) -> None:
    """Adds n to the host counter `name` of namespace `ns` (a module's
    globals), under one lock: shards of the fruit mesh launch from several
    threads. Always on."""
    with _lock:
        ns[name] += n


def add(name: str, t: torch.Tensor) -> None:
    """Adds the one-element tensor t to device counter `name` on t's device
    and current stream, without reading it back; only while tracing is on."""
    if not enabled():
        return
    stream = torch.cuda.current_stream(t.device) if t.is_cuda else None
    key = (name, t.device, stream)
    acc = _device.get(key)
    if acc is None:
        with _lock:
            acc = _device.setdefault(key, torch.zeros((), dtype=torch.int64, device=t.device))
    acc += t


def counters() -> Dict[str, int]:
    """The session's device counters, read once (after the devices that
    hold them finish their work)."""
    items = list(_device.items())
    for dev in {k[1] for k, _ in items if k[1].type == "cuda"}:
        torch.cuda.synchronize(dev)
    out: Dict[str, int] = {}
    for (name, _, _), acc in items:
        out[name] = out.get(name, 0) + int(acc.item())
    return out


def add_to_chrome_trace(path: str) -> None:
    """Appends the session's spans to the Chrome trace at `path` (as
    `torch.profiler` exports it), on that trace's clock, as complete events
    of category `program_span` (one row a thread, named "program spans"),
    and the device counters as `programCounters`."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    for tid in sorted({s.thread for s in spans()}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": "program spans"}})
    for s in spans():
        args = dict(s.attrs, sid=s.sid, parent=s.parent, group=s.group)
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": s.thread, "ts": (s.t0 + _offset_ns - base) / 1e3,
                       "dur": (s.t1 - s.t0) / 1e3, "args": args})
    doc["programCounters"] = counters()
    with open(path, "w") as f:
        json.dump(doc, f)
