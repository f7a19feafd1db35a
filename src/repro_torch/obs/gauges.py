"""Run-wide gauges: kernel builds, engine-state bytes, host RSS.

Counterpart of ``repro.obs.gauges``. The reference's recompile counter
listens to XLA's backend compiles; eager PyTorch compiles nothing a round.
The port's one compile is ``nvcc``, at a kernel library's first use
(``kernels.build.build_all``), which reports every run to its listeners:
``RecompileCounter`` counts those builds and their seconds, so a gauge
window's ``compiles`` answers the same question, did a round have to build
something, and steady-state rounds must show a delta of 0.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch


def tensor_bytes(tree) -> int:
    """Total bytes (``numel x element_size``) of the tensor and numpy leaves
    of ``tree``: dicts, tuples, lists and dataclasses (``OptState``), and the
    parameters, buffers and optimizer state of the sequential engines'
    modules and optimizers. Other leaves (ints, configs) count 0."""
    if isinstance(tree, torch.Tensor):
        # a DTensor (a sharded server suffix): this rank's own bytes
        local = getattr(tree, "to_local", None)
        t = tree if local is None else local()
        return t.numel() * t.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tensor_bytes(v) for v in tree)
    if isinstance(tree, torch.nn.Module):
        return tensor_bytes(list(tree.state_dict(keep_vars=True).values()))
    if isinstance(tree, torch.optim.Optimizer):
        return tensor_bytes(list(tree.state.values()))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tensor_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


def host_rss_bytes() -> int:
    """Current resident set size of this process, in bytes (0 if neither
    /proc nor the resource module can say)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        pass
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return 0


class RecompileCounter:
    """Counts kernel-library builds (``nvcc`` runs) and the seconds spent in
    them, from ``kernels.build``'s build events. ``install()`` registers the
    listener; snapshot with ``.count`` / ``.duration_s``; window deltas via
    ``snapshot()``.

    One module-level counter (``global_counter()``) is shared by every Obs
    instance so repeated runs never stack listeners; unit tests may build
    their own and ``uninstall()`` it.
    """

    def __init__(self):
        self.count = 0
        self.duration_s = 0.0
        self.available = False
        self._installed = False
        self._event: Optional[str] = None

    def install(self) -> "RecompileCounter":
        if self._installed:
            return self
        from ..kernels import build
        self._event = build.BUILD_EVENT
        build.register_build_listener(self._listen)
        self.available = True
        self._installed = True
        return self

    def _listen(self, event: str, duration: float, **kwargs) -> None:
        if event == self._event:
            self.count += 1
            self.duration_s += duration

    def uninstall(self) -> None:
        if not self._installed:
            return
        from ..kernels import build
        build.unregister_build_listener(self._listen)
        self._installed = False
        self.available = False

    def snapshot(self) -> tuple[int, float]:
        """(count, duration_s) so far — subtract two snapshots for a
        window delta."""
        return self.count, self.duration_s


_GLOBAL: Optional[RecompileCounter] = None


def global_counter() -> RecompileCounter:
    """The process-wide build counter, installed on first use."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = RecompileCounter().install()
    return _GLOBAL
