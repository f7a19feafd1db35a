"""Buffered JSONL event sink + run manifest.

Counterpart of ``repro.obs.sink``, a copy of its code (pinned equal by
``tests/test_torch_copies.py``). One run = one directory under
``results/runs/<run_id>/`` holding

* ``manifest.json`` — run-level metadata (spec ``describe()``, the torch
  and CUDA versions, the plan's device, git commit, argv), merged across
  writes so the compile seam and the entry point can both contribute;
* ``events.jsonl`` — one JSON object per line: spans, gauges, records,
  mission spans, notes (see ``tools/obs_report.py`` for the schema table).

``JsonlSink`` buffers events in memory and appends to disk every
``buffer`` events (and on flush/close), so the per-event hot-path cost is
one ``list.append``. ``NullSink`` is the disabled path: every method is a
no-op, nothing touches the filesystem. ``json_default`` coerces numpy
values and small torch tensors (``tolist()``) alike.
"""
from __future__ import annotations

import json
import os
import time


def json_default(o):
    """Coerce numpy scalars/arrays (and anything with ``item()``/
    ``tolist()``) for ``json.dumps``."""
    if hasattr(o, "tolist"):
        return o.tolist()
    if hasattr(o, "item"):
        return o.item()
    return str(o)


def new_run_id() -> str:
    """Sortable, collision-resistant: UTC timestamp + pid."""
    return time.strftime("%Y%m%d-%H%M%S", time.gmtime()) + f"-{os.getpid()}"


class NullSink:
    """The disabled sink: emit/flush/close are no-ops, no run dir exists."""
    run_dir = None

    def emit(self, event: dict) -> None:
        pass

    def write_manifest(self, fields: dict) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlSink:
    """Buffered append-only event stream + merged manifest for one run."""

    def __init__(self, run_dir: str, buffer: int = 256):
        self.run_dir = run_dir
        self._events_path = os.path.join(run_dir, "events.jsonl")
        self._manifest_path = os.path.join(run_dir, "manifest.json")
        self._buffer = max(int(buffer), 1)
        self._pending: list[dict] = []
        self._manifest: dict = {}
        os.makedirs(run_dir, exist_ok=True)

    def emit(self, event: dict) -> None:
        self._pending.append(event)
        if len(self._pending) >= self._buffer:
            self.flush()

    def write_manifest(self, fields: dict) -> None:
        """Merge ``fields`` into the manifest and rewrite it. The special
        keys ``plan`` and ``sweep`` APPEND to ``plans`` / ``sweeps`` lists —
        one run may compile several plans (the perf bench does) and launch
        several Monte-Carlo sweeps."""
        for key in ("plan", "sweep"):
            item = fields.pop(key, None)
            if item is not None:
                self._manifest.setdefault(key + "s", []).append(item)
        self._manifest.update(fields)
        with open(self._manifest_path, "w") as f:
            json.dump(self._manifest, f, indent=1, default=json_default)

    def flush(self) -> None:
        if not self._pending:
            return
        with open(self._events_path, "a") as f:
            for ev in self._pending:
                f.write(json.dumps(ev, default=json_default) + "\n")
        self._pending = []

    def close(self) -> None:
        self.flush()
