from .optimizers import (SGD, AdamW, FunctionalAdamW, OptState, adamw,
                         clip_by_global_norm, constant_schedule,
                         cosine_schedule, sgd, warmup_cosine)

__all__ = ["AdamW", "FunctionalAdamW", "OptState", "SGD", "adamw",
           "clip_by_global_norm", "constant_schedule", "cosine_schedule",
           "sgd", "warmup_cosine"]
