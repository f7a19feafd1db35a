"""Checkpoints in the reference's msgpack format (counterpart of
``repro.checkpoint``)."""
from .ckpt import (Stacked, checkpoint_meta, restore_checkpoint,
                   save_checkpoint, tree_flatten_with_paths)

__all__ = ["save_checkpoint", "restore_checkpoint", "checkpoint_meta",
           "tree_flatten_with_paths", "Stacked"]
