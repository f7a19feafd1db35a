from .optimizers import SGD, AdamW, adamw, sgd

__all__ = ["AdamW", "SGD", "adamw", "sgd"]
