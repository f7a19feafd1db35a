"""The paper's FL and SL configurations as specs (carried over from the reference).

A copy of ``repro.core.paper_train`` over ``repro_torch.api``:
``PaperTrainConfig`` is the historical config surface, and ``paper_spec``
turns one into the ``ExperimentSpec`` the old trainers stood for:

  FL : each client trains the FULL model on its shard for ``local_steps``
       minibatches; the server FedAvg's all client models each global round
       (``EngineSpec('fl', 'scan')``).
  SL : eEnergy-Split / SplitFed — the client prefix (cut at SL_{a,b}) runs
       locally; the smashed activations (and labels) go to the server model,
       which backprops and returns the cut gradient; the server updates per
       client batch (sequential, as the UAV visits clients one at a time);
       the client prefixes are FedAvg'd every global round
       (``EngineSpec('sl', 'scan')``).

Run them with ``repro_torch.api.compile_experiment(paper_spec(cfg, kind),
data=...)``. ``tests/test_torch_copies.py`` holds ``paper_spec`` equal to
the reference's, field by field.
"""
from __future__ import annotations

import dataclasses

from ..api import (ClientSpec, CutPolicy, DataSpec, EngineSpec,
                   ExperimentSpec, LinkPolicy, ModelSpec)
# the per-step FLOP counters, re-exported as the reference re-exports them
from ..api.runtime import (count_fl_step_flops,  # noqa: F401
                           count_sl_step_flops)


@dataclasses.dataclass
class PaperTrainConfig:
    model: str = "mobilenetv2"
    num_clients: int = 4
    classes_per_client: int = 3
    num_classes: int = 12
    client_fraction: float = 0.25      # SL_{a,b}: a = client share
    global_rounds: int = 8
    local_steps: int = 4
    batch_size: int = 16
    lr: float = 1e-3
    image_size: int = 32
    compress_link: bool = False
    seed: int = 0


def paper_spec(cfg: PaperTrainConfig, kind: str) -> ExperimentSpec:
    """The ``ExperimentSpec`` a ``PaperTrainConfig`` stands for. ``kind`` is
    ``'fl'`` or ``'sl'``; both lower to the sequential
    (``client_axis='scan'``) engines the faithful reproduction uses."""
    return ExperimentSpec(
        model=ModelSpec(name=cfg.model, num_classes=cfg.num_classes),
        data=DataSpec(kind="arrays", image_size=cfg.image_size,
                      classes_per_client=cfg.classes_per_client,
                      shrink_batches=True),
        clients=ClientSpec(num_clients=cfg.num_clients),
        cut_policy=CutPolicy(mode="fraction", fraction=cfg.client_fraction),
        link_policy=LinkPolicy(
            compress="int8" if cfg.compress_link else "none"),
        engine=EngineSpec(kind=kind, client_axis="scan"),
        global_rounds=cfg.global_rounds, local_steps=cfg.local_steps,
        batch_size=cfg.batch_size, lr=cfg.lr, seed=cfg.seed)
