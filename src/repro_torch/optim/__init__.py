from .optimizers import (SGD, AdamW, FunctionalAdamW, OptState, adamw,
                         clip_by_global_norm, sgd)

__all__ = ["AdamW", "FunctionalAdamW", "OptState", "SGD", "adamw",
           "clip_by_global_norm", "sgd"]
