"""The port's experiment layer: ``ExperimentSpec`` -> ``compile_experiment``
-> ``Plan`` -> ``RoundRecord`` (counterpart of ``repro.api``)."""
from .plan import Plan, PlanState, compile_experiment
from .records import RoundRecord
from .spec import (ClientSpec, CutPolicy, DataSpec, EngineSpec,
                   ExperimentSpec, LinkPolicy, MissionSpec, ModelSpec)

__all__ = ["ClientSpec", "CutPolicy", "DataSpec", "EngineSpec",
           "ExperimentSpec", "LinkPolicy", "MissionSpec", "ModelSpec", "Plan",
           "PlanState", "RoundRecord", "compile_experiment"]
