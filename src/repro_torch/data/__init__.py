"""Data pipeline of the port: synthetic token source, Equilibrium shard
assignment, prefetching loader (the counterpart of ``src/repro/data/``)."""

from .pipeline import (DataShard, ShardAssignment, SyntheticTokenSource,
                       TokenLoader, assign_shards)

__all__ = ["DataShard", "ShardAssignment", "SyntheticTokenSource",
           "TokenLoader", "assign_shards"]
