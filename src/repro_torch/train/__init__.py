"""Training substrate of the port: so far the sharded checkpoint with its
bloomRF layer-range index.  The optimizer, the train loop and fault
tolerance of ``repro.train`` are ROADMAP A.11."""
from .checkpoint import (AsyncSaver, latest_step, restore_checkpoint,
                         restore_layer_range, save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_layer_range",
           "latest_step", "AsyncSaver"]
