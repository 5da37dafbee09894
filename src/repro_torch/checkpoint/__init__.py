"""Checkpoint-shard placement of the port (the counterpart of
``src/repro/checkpoint/placement.py``); writing and restoring checkpoints
(``checkpoint.py``) is not ported yet."""

from .placement import CheckpointPlacement, StorageHost, plan_placement

__all__ = ["CheckpointPlacement", "StorageHost", "plan_placement"]
