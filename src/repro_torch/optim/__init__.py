from .optimizers import SGD, AdamW, adamw, clip_by_global_norm, sgd

__all__ = ["AdamW", "SGD", "adamw", "clip_by_global_norm", "sgd"]
