"""``repro_torch.obs`` — run-wide telemetry behind every compiled Plan.

Counterpart of ``repro.obs``. Zero-dependency beyond torch and numpy,
**off by default**: a plan compiled without ``obs=ObsConfig(...)`` carries
the shared disabled instance whose every hot-path touch is a branch plus a
no-op call. Enabled, one run writes

    results/runs/<run_id>/
      manifest.json     # spec describe(), torch/CUDA, device, git commit
      events.jsonl      # spans, gauges, records, metrics, mission spans
      profile/          # optional torch.profiler trace (profile_rounds=)

through four pieces (each its own module):

* ``timeline``  — nestable phase timers with explicit device fencing
  (``span.fence`` separates device-sync wait from host cost);
* ``gauges``    — kernel-build counter (``nvcc`` runs), engine-state
  bytes (the O(cohort) pin), host RSS;
* ``sink``      — buffered JSONL event stream + merged run manifest;
* ``profiler``  — opt-in ``torch.profiler`` capture scoped to rounds N..M.

``metrics`` is the in-round metrics bus (``MetricsConfig``). Render a run
with ``tools/obs_report.py <run_dir>``.

Usage::

    from repro_torch.obs import ObsConfig
    plan = compile_experiment(spec, obs=ObsConfig())
    state, records = plan.run()          # spans/gauges/records stream out
    plan.obs.close()                     # flush the sink
    print(plan.obs.run_dir)
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional, Tuple

import torch

from .gauges import global_counter, host_rss_bytes, tensor_bytes
from .metrics import MetricsConfig, NonfiniteError  # noqa: F401 (re-export)
from .profiler import ProfilerCapture
from .sink import JsonlSink, NullSink, json_default, new_run_id
from .timeline import (NULL_SPAN, Timeline, fenced,  # noqa: F401 (re-export)
                       time_fenced)

__all__ = ["Obs", "ObsConfig", "NULL_OBS", "MetricsConfig", "NonfiniteError",
           "tensor_bytes", "host_rss_bytes", "fenced", "time_fenced",
           "json_default"]


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Telemetry knobs handed to ``compile_experiment(..., obs=)``."""
    enabled: bool = True
    run_root: str = "results/runs"   # run dirs are created under here
    run_id: Optional[str] = None     # default: UTC timestamp + pid
    gauge_every: int = 1             # rounds between gauge stamps (0 = off)
    # (start, stop) inclusive round window for torch.profiler capture;
    # None keeps the profiler off (it is never free)
    profile_rounds: Optional[Tuple[int, int]] = None
    buffer_events: int = 256         # sink flush granularity
    # in-round metrics bus (see ``repro_torch.obs.metrics``): None keeps
    # every round on the tensor operations of the metrics-free program.
    # Orthogonal to ``enabled`` — ObsConfig(enabled=False,
    # metrics=MetricsConfig()) computes RoundRecord.metrics with no sink.
    metrics: Optional[MetricsConfig] = None


def _git_commit() -> str:
    import subprocess
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True,
                              timeout=10).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


class Obs:
    """One run's telemetry facade: timeline + gauges + sink + profiler.

    Truthiness is the enabled flag — hot paths guard with ``if obs:``.
    Every method on a disabled instance is safe and does nothing.
    """

    def __init__(self, config: Optional[ObsConfig] = None):
        self.config = config = config if config is not None else ObsConfig()
        self.enabled = config.enabled
        if not self.enabled:
            self.sink = NullSink()
            self.timeline = Timeline(self.sink, enabled=False)
            self.profiler = ProfilerCapture(None, "")
            self._counter = None
            return
        import os
        run_id = config.run_id or new_run_id()
        run_dir = os.path.join(config.run_root, run_id)
        self.sink = JsonlSink(run_dir, buffer=config.buffer_events)
        self.timeline = Timeline(self.sink, enabled=True)
        cuda = torch.cuda.is_available()
        self.profiler = ProfilerCapture(config.profile_rounds,
                                        os.path.join(run_dir, "profile"),
                                        cuda=cuda, timeline=self.timeline)
        self._counter = global_counter()
        self._compiles0, self._compile_s0 = self._counter.snapshot()
        self._gauge_mark = self._compiles0, self._compile_s0
        self.manifest(
            run_id=run_id,
            created_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda,
            # the plan's device once compile_experiment names it
            backend="cuda" if cuda else "cpu",
            device_count=torch.cuda.device_count(),
            git_commit=_git_commit(),
            argv=list(sys.argv),
            recompile_counter=("available" if self._counter.available
                               else "unavailable"),
        )

    # ---- construction helpers --------------------------------------------

    @classmethod
    def ensure(cls, obs) -> "Obs":
        """Normalize the ``obs=`` argument: None -> the shared disabled
        instance, an ObsConfig -> a fresh Obs, an Obs -> itself."""
        if obs is None:
            return NULL_OBS
        if isinstance(obs, ObsConfig):
            return cls(obs)
        return obs

    @classmethod
    def disabled(cls) -> "Obs":
        return cls(ObsConfig(enabled=False))

    def __bool__(self) -> bool:
        return self.enabled

    @property
    def run_dir(self) -> Optional[str]:
        return self.sink.run_dir

    def set_device(self, device: torch.device) -> None:
        """Record the plan's device: ``backend`` (and on CUDA the card's
        name) in the manifest, and whether the profiler traces the card."""
        if not self.enabled:
            return
        self.profiler.cuda = device.type == "cuda"
        fields = {"backend": device.type}
        if device.type == "cuda":
            fields["device_name"] = torch.cuda.get_device_name(device)
        self.manifest(**fields)

    # ---- event stream -----------------------------------------------------

    def span(self, name: str, **fields):
        """Nestable phase timer (see ``obs.timeline``)."""
        return self.timeline.span(name, **fields)

    def event(self, ev: str, **fields) -> None:
        """Emit one free-form event line (``ev`` names its type)."""
        if not self.enabled:
            return
        self.sink.emit({
            "ev": ev,
            "t": round(self.timeline.elapsed(), 6),
            **fields})

    def record(self, round_record) -> None:
        """Emit a RoundRecord as a ``record`` event (JSON-safe to_dict)."""
        if not self.enabled:
            return
        self.event("record", **round_record.to_dict())

    def gauge(self, round_index: int, engine_state=None, **fields) -> None:
        """Stamp the per-round gauges: kernel builds since the last stamp,
        engine-state bytes, host RSS, plus any caller tallies (cohort
        size, dropped clients, link bytes, ...)."""
        if not self.enabled:
            return
        every = self.config.gauge_every
        if every <= 0 or round_index % every:
            return
        ev = {"round": round_index,
              "rss_bytes": host_rss_bytes(), **fields}
        if engine_state is not None:
            ev["state_bytes"] = tensor_bytes(engine_state)
        if self._counter is not None and self._counter.available:
            c, s = self._counter.snapshot()
            c0, s0 = self._gauge_mark
            ev["compiles"] = c - c0
            ev["compile_s"] = round(s - s0, 6)
            self._gauge_mark = (c, s)
        self.event("gauge", **ev)

    def compiles_total(self) -> int:
        """Kernel builds since this Obs was created (0 if the counter is
        unavailable)."""
        if self._counter is None or not self._counter.available:
            return 0
        return self._counter.snapshot()[0] - self._compiles0

    def manifest(self, **fields) -> None:
        """Merge fields into ``manifest.json`` (``plan=`` appends to the
        manifest's ``plans`` list — one run may compile several)."""
        self.sink.write_manifest(fields)

    # ---- profiler + lifecycle --------------------------------------------

    def round_started(self, round_index: int) -> None:
        if self.enabled:
            self.profiler.round_started(round_index)

    def round_finished(self, round_index: int) -> None:
        if self.enabled:
            self.profiler.round_finished(round_index)

    def flush(self) -> None:
        self.sink.flush()

    def close(self) -> None:
        """Stop a live profiler capture, record its status, flush."""
        if self.enabled:
            self.profiler.close()
            if self.profiler.status != "off":
                self.manifest(profiler=self.profiler.status)
        self.sink.close()


NULL_OBS = Obs(ObsConfig(enabled=False))
