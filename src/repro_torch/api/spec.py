"""Declarative experiment specs — one dataclass tree for every round shape.

Re-declaration of ``repro.api.spec`` for the port: the same dataclasses,
fields, defaults and ``describe()`` strings, so one spec reads the same in
both packages. ``ModelSpec.arch`` takes the port's
``repro_torch.configs.base.ArchConfig`` and ``ExperimentSpec.scenario`` the
port's ``repro_torch.sim.ScenarioSpec``. The engine lowering table is in
``repro.api.spec``'s docstring; the port lowers ``fl/scan``, ``sl/scan``,
``fl/vmap`` and ``sl/vmap`` so far (``repro_torch.api.plan``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from ..core.energy import HardwareProfile, JETSON_AGX_ORIN
from ..core.link import LinkConfig
from ..core.uav_energy import DEFAULT_UAV, UAVParams
from ..sim.scenario import ScenarioSpec


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    family: str = "cnn"          # "cnn" (Stage lists) | "transformer"
    name: str = "tinycnn"        # cnn: key into models.cnn.CNN_BUILDERS
    num_classes: int = 12        # cnn label space (transformers use arch.vocab)
    # transformer family: the ArchConfig whose stacked attention blocks are
    # split at the CutPolicy fraction (fleet.hetero.lm_split_program — embed
    # + prefix blocks on the client, suffix blocks + LM head on the server)
    arch: Optional[Any] = None
    # attention kernel for the transformer blocks (kernels.dispatch):
    # "xla" (chunked jnp path, bit-identical default) | "pallas" (flash
    # kernel; interpret mode off-accelerator) | "ref" (O(S²) oracle) |
    # "auto" (pallas on TPU/GPU, xla on CPU)
    attn_impl: str = "xla"


@dataclasses.dataclass(frozen=True)
class DataSpec:
    kind: str = "synthetic"      # "synthetic" | "arrays" (pass data= at
    #                              compile) | "tokens" (synthetic LM stream)
    image_size: int = 32
    classes_per_client: int = 3  # non-IID shards (paper §IV-C)
    # client partition: "classes" (paper §IV-C fixed classes-per-client) |
    # "dirichlet" (label-skew, Dirichlet(alpha) per class) | "iid"
    partition: str = "classes"
    dirichlet_alpha: float = 0.5
    seq_len: int = 32            # tokens kind: sequence length per sample
    n_train: int = 0             # 0 -> heuristic from fleet size/classes
    n_test: int = 0
    shrink_batches: bool = False  # cap batch at smallest partition (legacy
    #                               paper_train behaviour; campaigns keep
    #                               exact batch_size so hoisted constants hold)


@dataclasses.dataclass(frozen=True)
class ClientSpec:
    num_clients: int = 4
    # heterogeneity source: profiles cycled across clients (Eq. 9 scaling
    # and, under an adaptive CutPolicy, per-client cut selection). With a
    # population, profiles cycle over POPULATION ids and are gathered to
    # the sampled cohort each round.
    edge_profiles: Tuple[HardwareProfile, ...] = (JETSON_AGX_ORIN,)
    # P3SL-style straggler masking: per-round probability a client drops
    # out of training/aggregation (fleet engines only; >=1 client kept)
    dropout_rate: float = 0.0
    # cross-device scale: the total client population M the per-round
    # cohort of K = num_clients participants is sampled from (uniform, or
    # availability-weighted under a scenario trace — sim.sample_cohort).
    # None == today's fully-materialized fleet (no sampling); population
    # == num_clients is the degenerate corner that reproduces the
    # materialized records exactly; population > num_clients keeps engine
    # state O(K): FL cohorts are stateless, parallel-SL cohorts share one
    # client tier (EPSL).
    population: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class CutPolicy:
    mode: str = "fraction"       # "fraction" | "adaptive"
    fraction: float = 0.25       # SL_{a,b}: client holds a% of layers
    min_client_layers: int = 1   # privacy floor (raw data stays on device)
    # per-step link deadline for adaptive selection; None + mission ->
    # derived from the UAV hover window (runtime.mission_max_link_s)
    max_link_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class LinkPolicy:
    rate_bps: float = 100e6
    compress: str = "none"       # "none" | "int8"
    radio_power_w: float = 2.0

    def config(self) -> LinkConfig:
        return LinkConfig(rate_bps=self.rate_bps, compress=self.compress,
                          radio_power_w=self.radio_power_w)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    kind: str = "sl"             # "fl" | "sl"
    # "scan" (sequential) | "vmap" (fleet, GSPMD-inferred collectives) |
    # "shard_map" (fleet, explicit fedavg_pmean / in-map lax.pmean)
    client_axis: str = "scan"
    server_reduce: str = "mean"  # fleet SL server gradient reduction
    # (fsdp, tp) sizes of the server suffix's 2D sub-mesh; None -> (1, 1).
    # compile_experiment grows the fleet mesh to ('data','fsdp','tp') and
    # shards the SL server params/optimizer state with the
    # launch.steps.fleet_server_pspecs tier specs.
    server_mesh: Optional[Tuple[int, int]] = None
    # int8 link-boundary kernel (only bites with LinkPolicy.compress="int8"):
    # "xla" (two-op jnp quant/dequant reference, default) | "fused" (ONE
    # Pallas kernel: quant + per-row scale + dequant; interpret mode
    # off-accelerator) | "auto" (fused on TPU/GPU, xla on CPU)
    link_kernel: str = "xla"

    @property
    def is_fleet(self) -> bool:
        return self.client_axis in ("vmap", "shard_map")


@dataclasses.dataclass(frozen=True)
class MissionSpec:
    farm_acres: float = 100.0
    uav: UAVParams = DEFAULT_UAV
    hover_s_per_stop: float = 30.0
    comm_s_per_stop: float = 10.0


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    model: ModelSpec = ModelSpec()
    data: DataSpec = DataSpec()
    clients: ClientSpec = ClientSpec()
    cut_policy: CutPolicy = CutPolicy()
    link_policy: LinkPolicy = LinkPolicy()
    engine: EngineSpec = EngineSpec()
    mission: Optional[MissionSpec] = None   # None -> no tour/budget/UAV terms
    # stochastic environment (repro.sim): A2G channel draws, availability
    # traces, multi-UAV dispatch. None keeps the idealized constants; the
    # degenerate scenario reproduces them exactly (sim.degenerate_scenario)
    scenario: Optional[ScenarioSpec] = None
    global_rounds: int = 4       # cap; a mission's UAV budget may cut it short
    local_steps: int = 2
    batch_size: int = 8
    lr: float = 1e-3
    seed: int = 0

    def describe(self) -> str:
        """One-line engine label for records/logs."""
        cut = (self.cut_policy.mode if self.engine.kind == "sl" else "-")
        pop = self.clients.population
        cohort = ("" if pop is None
                  else f",cohort={self.clients.num_clients}/{pop}")
        return (f"{self.engine.kind}/{self.engine.client_axis}"
                f"[cut={cut},link={self.link_policy.compress},"
                f"mission={'yes' if self.mission else 'no'}{cohort}]")
