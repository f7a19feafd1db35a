"""Placements over a ``torch.distributed`` device mesh (counterpart of
``repro.parallel``)."""
from .sharding import (DP_AXES, FSDP_AXIS, TP_AXIS, AbstractMesh, P,
                       ShardingPolicy, get_policy, model_pspecs,
                       param_pspecs, set_policy, shard_act, to_placements)

__all__ = ["AbstractMesh", "P", "ShardingPolicy", "set_policy", "get_policy",
           "shard_act", "param_pspecs", "model_pspecs", "to_placements",
           "DP_AXES", "TP_AXIS", "FSDP_AXIS"]
