"""Distributed checkpointing of the port: Equilibrium-placed shards,
atomic manifests, restore as host NumPy (the counterpart of
``src/repro/checkpoint/``)."""

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .placement import CheckpointPlacement, StorageHost, plan_placement

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointPlacement", "StorageHost", "plan_placement"]
