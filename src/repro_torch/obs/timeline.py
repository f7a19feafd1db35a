"""Nestable phase timers with correct device fencing.

Counterpart of ``repro.obs.timeline``. CUDA launches are asynchronous:
``fn(x)`` returns as soon as the work is *queued*, so
``time.perf_counter()`` around a call measures the launches, not the
execution. Every timer here is explicit about where the fence sits:

* ``Timeline.span("round/execute")`` — a nestable phase timer on the
  monotonic clock. Inside a span, ``sp.fence(value)`` blocks until the
  devices holding ``value``'s tensors have finished their queued work and
  books the wait into the span's ``sync_s``; the emitted event carries
  ``dur_s`` (wall) and ``sync_s`` (device wait) separately, so host cost =
  ``dur_s - sync_s``.
* ``time_fenced(fn, repeats=N)`` — the bench primitive: call ``fn`` ``N``
  times back-to-back, fence ONCE on the last result, return wall seconds
  (a fence a call would serialize the launches against the work).
* ``fenced(fn)`` — call once, fence on the result, return ``(out,
  wall_s)``. For host values (numpy, floats) the fence is a no-op.

The fence (``_block``) walks the value — tensors, dicts, tuples, lists and
dataclasses such as ``OptState`` — and calls ``torch.cuda.synchronize`` once
for each CUDA device among its tensors: the port's only fence.

Spans nest lexically: the timeline keeps a stack, and every event records
its full ``path`` ("run/round/execute") plus ``depth``, so a reader can
rebuild the tree without matching ids. Disabled timelines hand out one
shared null span — entering it is a branch and two no-op calls.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch


def _cuda_devices(value: Any, found: set) -> None:
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), found)


def _block(value: Any) -> Any:
    """Wait until every CUDA device holding a tensor of ``value`` has
    finished its queued work (one ``synchronize`` a device). Host leaves
    (numpy arrays, floats, configs) and CPU tensors are already ready."""
    found: set = set()
    _cuda_devices(value, found)
    for device in found:
        torch.cuda.synchronize(device)
    return value


def fenced(fn: Callable[[], Any]) -> tuple[Any, float]:
    """``(out, wall_s)`` of one fenced call: launches + device execution,
    never the launches alone."""
    t0 = time.perf_counter()
    out = fn()
    _block(out)
    return out, time.perf_counter() - t0


def time_fenced(fn: Callable[[], Any], repeats: int = 1) -> float:
    """Wall seconds of ``repeats`` back-to-back calls of ``fn`` with ONE
    fence on the final result — the throughput-bench clock (queue the
    whole window, block at the end)."""
    out = None
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn()
    _block(out)
    return time.perf_counter() - t0


def count_host_syncs(fn: Callable[[], Any]) -> tuple[Any, int]:
    """``(out, n)``: ``fn()`` under ``torch.cuda.set_sync_debug_mode
    ("warn")``, ``n`` the synchronizing CUDA operations it ran (each one a
    warning). Only the warnings raised while ``fn`` runs count: a process's
    first switch of the mode can warn once itself. On the card only."""
    import warnings
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        start = len(caught)
        try:
            out = fn()
        finally:
            ran = caught[start:]
            torch.cuda.set_sync_debug_mode(prev)
    return out, sum("synchronizing" in str(w.message) for w in ran)


class _NullSpan:
    """Shared do-nothing span for disabled timelines."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, value):
        return value

    def note(self, **fields):
        return None


NULL_SPAN = _NullSpan()


class Span:
    """One live phase. Use as a context manager via ``Timeline.span``.

    Names may be hierarchical ("round/execute"); the emitted ``path``
    splices them into the enclosing stack without duplicating shared
    segments, so ``span("round")`` containing ``span("round/execute")``
    yields the path ``.../round/execute``, not ``.../round/round/execute``.
    """
    __slots__ = ("_tl", "name", "fields", "t_start", "sync_s", "_extra",
                 "_pushed", "_depth")

    def __init__(self, tl: "Timeline", name: str, fields: dict):
        self._tl = tl
        self.name = name
        self.fields = fields
        self.sync_s = 0.0
        self._extra: Optional[dict] = None

    def __enter__(self):
        tl = self._tl
        stack = tl._stack
        segs = self.name.split("/")
        # drop the longest prefix of this name that repeats the stack tail
        k = 0
        for i in range(min(len(segs), len(stack)), 0, -1):
            if stack[len(stack) - i:] == segs[:i]:
                k = i
                break
        if k == len(segs):        # name identical to the stack tail: still
            k = len(segs) - 1     # push the leaf so pop stays balanced
        self._pushed = len(segs) - k
        stack.extend(segs[k:])
        self._depth = tl._open
        tl._open += 1
        self.t_start = time.perf_counter()
        return self

    def fence(self, value):
        """Block until ``value``'s devices are done; the wait books into
        this span's ``sync_s`` (device time the host spent waiting)."""
        t0 = time.perf_counter()
        _block(value)
        self.sync_s += time.perf_counter() - t0
        return value

    def note(self, **fields):
        """Attach extra fields to the span's emitted event."""
        if self._extra is None:
            self._extra = {}
        self._extra.update(fields)

    def __exit__(self, *exc):
        t_end = time.perf_counter()
        tl = self._tl
        stack = tl._stack
        path = "/".join(stack)
        del stack[len(stack) - self._pushed:]
        tl._open -= 1
        event = {
            "ev": "span",
            "name": self.name,
            "path": path,
            "depth": self._depth,
            "t": round(self.t_start - tl.t0, 6),
            "dur_s": round(t_end - self.t_start, 6),
            "sync_s": round(self.sync_s, 6),
        }
        if self.fields:
            event.update(self.fields)
        if self._extra:
            event.update(self._extra)
        tl._sink.emit(event)
        return False


class Timeline:
    """Nestable span timers writing one event per closed span to a sink."""

    def __init__(self, sink, enabled: bool = True):
        self._sink = sink
        self.enabled = enabled
        self._stack: list[str] = []   # path segments of the open spans
        self._open = 0                # count of open spans (event depth)
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        """Seconds on the run clock since the timeline started: a free
        event's time stamp (no window, so no fence)."""
        return time.perf_counter() - self.t0

    def span(self, name: str, **fields) -> Any:
        """``with tl.span("round/execute"): ...`` — disabled timelines
        return the shared null span (branch-only cost)."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, fields)
