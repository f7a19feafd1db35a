"""Opt-in ``torch.profiler`` trace capture scoped to rounds N..M of a run.

Counterpart of ``repro.obs.profiler``. ``ObsConfig(profile_rounds=(2, 4))``
arms a capture that starts when round 2 begins and stops after round 4
ends: host operator events, and the CUDA kernels where the plan runs on the
card (``cuda``, set by ``compile_experiment`` from the plan's device). The
trace is exported as a Chrome trace to ``<run_dir>/profile/trace.json``
(Perfetto opens it). Capture failures never fail the run — the status
lands in the manifest instead (``"unavailable: ..."``). With a
``timeline`` the profiler's own start and stop (the trace's export
included) are timed as ``profiler/start`` and ``profiler/stop`` spans, so
a run's phases account for them.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

from .timeline import NULL_SPAN

TRACE_FILE = "trace.json"


class ProfilerCapture:
    """Start/stop ``torch.profiler.profile`` around a contiguous round
    window."""

    def __init__(self, rounds: Optional[Tuple[int, int]], out_dir: str,
                 cuda: bool = False, timeline=None):
        self.rounds = tuple(rounds) if rounds is not None else None
        if self.rounds is not None and self.rounds[0] > self.rounds[1]:
            raise ValueError(f"profile_rounds=(start, stop) needs start <= "
                             f"stop, got {self.rounds}")
        self.out_dir = out_dir
        self.cuda = cuda
        self._timeline = timeline
        self.active = False
        self.status = "off" if self.rounds is None else "armed"
        self._prof = None

    @property
    def trace_path(self) -> str:
        return os.path.join(self.out_dir, TRACE_FILE)

    def _span(self, name: str, round_index: Optional[int]):
        if self._timeline is None:
            return NULL_SPAN
        return self._timeline.span(name, round=round_index)

    def round_started(self, round_index: int) -> None:
        if (self.rounds is None or self.active
                or round_index != self.rounds[0]):
            return
        with self._span("profiler/start", round_index):
            try:
                from torch.profiler import ProfilerActivity, profile
                activities = [ProfilerActivity.CPU]
                if self.cuda:
                    activities.append(ProfilerActivity.CUDA)
                os.makedirs(self.out_dir, exist_ok=True)
                self._prof = profile(activities=activities)
                self._prof.start()
                self.active = True
                self.status = (f"tracing rounds "
                               f"{self.rounds[0]}..{self.rounds[1]}")
            except Exception as e:                  # never fail the run
                self._prof = None
                self.status = f"unavailable: {type(e).__name__}: {e}"

    def round_finished(self, round_index: int) -> None:
        if self.active and round_index >= self.rounds[1]:
            self._stop(round_index)

    def close(self) -> None:
        """Stop a still-open capture (a run shorter than the window)."""
        if self.active:
            self._stop(None)

    def _stop(self, round_index: Optional[int]) -> None:
        with self._span("profiler/stop", round_index):
            try:
                self._prof.stop()
                self._prof.export_chrome_trace(self.trace_path)
                self.status = f"captured -> {self.out_dir}"
            except Exception as e:
                self.status = f"stop failed: {type(e).__name__}: {e}"
        self._prof = None
        self.active = False
