"""The uniform per-round record every compiled plan emits.

One ``RoundRecord`` per executed global round, regardless of which engine
ran it — FL or SL, scanned or fleet-vmapped, homogeneous or hetero-cut,
with or without a UAV mission. Fields an engine has nothing to say about
are zero (e.g. ``link_*`` for FL, ``uav_energy_j`` without a mission), so
downstream consumers (campaign totals, benches, reports) read one schema.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    round: int
    loss: float                  # mean training loss over ACTIVE clients
    accuracy: float              # held-out accuracy after the round (nan if
                                 # the round ran without evaluation)
    link_bytes: float            # wire bytes this round (all active clients)
    link_time_s: float
    link_energy_j: float         # edge radio transmit energy (L/R * P_radio)
    client_energy_j: float       # edge compute, Eq. (9)-scaled
    server_energy_j: float
    uav_energy_j: float          # tour energy for this round (Alg. 2)
    client_time_s: float = 0.0   # edge compute seconds behind client_energy_j
    server_time_s: float = 0.0
    active_clients: int = -1     # clients that survived dropout this round
    engine: str = ""             # "fl/scan" | "fl/vmap" | "sl/scan" | "sl/vmap"
    # population ids behind this round's cohort slots (ClientSpec.population
    # sampling; empty when the fleet is fully materialized). Slot i of every
    # per-client quantity this round belonged to population client
    # cohort_pids[i].
    cohort_pids: tuple = ()
    # metrics-bus summary of the round (repro.obs.metrics): a flat
    # JSON-able scalar dict keyed "<channel>/<stat>" ("grad_norm_client/
    # mean", "health/nonfinite", ...). Empty unless the plan was compiled
    # with ObsConfig(metrics=MetricsConfig(...)).
    metrics: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        """JSON-serializable dict of the record. Field values can arrive as
        numpy scalars (``cohort_pids`` gathered from a device cohort,
        metrics pulled out of jitted evals) and ``json.dumps`` refuses
        those — every scalar is coerced to its Python equivalent here, so
        any sink/report can dump the result verbatim."""
        return {k: _jsonable(v)
                for k, v in dataclasses.asdict(self).items()}


def _jsonable(v):
    """Python-native scalar(s) for one record field: numpy/jax scalars via
    ``item()``, tuples element-wise (``cohort_pids``), dicts value-wise
    (``metrics``)."""
    if isinstance(v, tuple):
        return tuple(_jsonable(x) for x in v)
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if hasattr(v, "item"):
        return v.item()
    return v
