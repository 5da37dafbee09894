"""Distribution of the port: Equilibrium-planned MoE expert placement
(the counterpart of ``src/repro/sharding/expert_placement.py``); the
partition specs and the sharding context are not ported yet."""

from . import expert_placement

__all__ = ["expert_placement"]
