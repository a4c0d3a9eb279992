"""CUDA graphs of the LM iteration's own code, replayed in place of its
small eager operations.

An LM iteration enqueues a few hundred small kernels around its two decoder
terms (`optim/lm.lm_iteration`); launched one by one from Python, they cost
the host more time than the card needs to run them. The code between the
decoder terms is captured once per key as a few graph segments and then
replayed: the host enqueues a replay where it enqueued each operation.

`IterationGraphs` holds the segments of one key. A segment is a function
of tensors returning a tuple of tensors. On its first run it is captured:
its inputs are copied into static buffers (with the callers' strides, so
every kernel sees the layout the eager code sees), it is captured on a
side stream with `capture_error_mode="thread_local"` (other threads keep
using the card) into the key's memory pool, and is replayed. The key's
first iteration ran the same code eagerly, so nothing is set up lazily
inside the capture. Later runs copy into the
static buffers only the inputs that are not already there: a buffer of an
earlier segment passed on is used as it is, and a source tensor fed
before is not fed again while it is the same object at the same version
(the observations of a solve). A segment's outputs are static: the next
replay overwrites them, so what leaves the iteration is copied by the
caller.

Kernels of the port launched inside a segment are counted per replay
(`ops/linalg.captured_launches`).
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from hortimapping_tpu_torch.ops import linalg
from hortimapping_tpu_torch.utils import trace

_capture_lock = threading.Lock()     # one capture at a time: they share a side stream
_side: Dict[int, torch.cuda.Stream] = {}


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    s = _side.get(dev.index)
    if s is None:
        s = _side[dev.index] = torch.cuda.Stream(dev)
    return s


class _Segment:
    __slots__ = ("graph", "ins", "outs", "solves")

    def __init__(self, graph, ins, outs, solves):
        self.graph, self.ins, self.outs, self.solves = graph, ins, outs, solves


class IterationGraphs:
    """The captured segments of one key on one device and stream, held by
    one thread for a whole iteration: `acquire` returns False while another
    thread holds them, and that thread's iteration then runs eagerly."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.pool = torch.cuda.graph_pool_handle()
        self.segments: Dict[str, _Segment] = {}
        self._statics: List[torch.Tensor] = []
        self._fed: Dict[int, Tuple[weakref.ref, int]] = {}   # id(buffer) -> (source, version)
        self._lock = threading.Lock()

    def acquire(self) -> bool:
        return self._lock.acquire(blocking=False)

    def release(self) -> None:
        self._lock.release()

    def _buffer_for(self, src: torch.Tensor) -> torch.Tensor:
        """The static buffer of a new segment's input: a static tensor
        passed on, the buffer this source was fed into, or a new one."""
        for buf in self._statics:
            if src is buf:
                return buf
        for buf in self._statics:
            rec = self._fed.get(id(buf))
            if rec is not None and rec[0]() is src and rec[1] == src._version:
                return buf
        buf = torch.empty_strided(src.shape, src.stride(), dtype=src.dtype, device=src.device)
        self._statics.append(buf)
        return buf

    def _feed(self, bufs: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor]) -> None:
        dst, src = [], []
        for buf, s in zip(bufs, srcs):
            if s is buf:
                continue
            rec = self._fed.get(id(buf))
            if rec is not None and rec[0]() is s and rec[1] == s._version:
                continue
            dst.append(buf)
            src.append(s)
            self._fed[id(buf)] = (weakref.ref(s), s._version)
        if dst:
            torch._foreach_copy_(dst, src)

    def run(self, name: str, fn: Callable[..., tuple], *srcs: torch.Tensor) -> tuple:
        """fn(*srcs) as the replay of segment `name`, captured at its first
        run. Returns the segment's static outputs."""
        seg = self.segments.get(name)
        if seg is None:
            seg = self.segments[name] = self._capture(fn, srcs)
        else:
            self._feed(seg.ins, srcs)
        seg.graph.replay()
        if seg.solves:
            trace.count(vars(linalg), "launches", seg.solves)
        return seg.outs

    def _capture(self, fn, srcs) -> _Segment:
        ins = [self._buffer_for(s) for s in srcs]
        self._feed(ins, srcs)
        cur = torch.cuda.current_stream(self.dev)
        graph = torch.cuda.CUDAGraph()
        with _capture_lock:
            side = _side_stream(self.dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                linalg.captured_launches(reset=True)
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    outs = tuple(fn(*ins))
                finally:
                    graph.capture_end()
                solves = linalg.captured_launches(reset=True)
            cur.wait_stream(side)
        self._statics.extend(outs)
        return _Segment(graph, ins, outs, solves)
