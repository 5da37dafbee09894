"""repro_torch.fleet — multi-cluster planning as a service.

The batch engine (:mod:`repro_torch.core.equilibrium_batch`) plans one
cluster a chunk; this package plans a *fleet*: independent clusters are
padded into shared shape buckets (:mod:`~repro_torch.fleet.pack`), one
step of the batch engine's chunk with a leading lane axis plans every
cluster of a bucket, its selection one launch of kernel K1 for all of
them (:mod:`~repro_torch.fleet.planner`, bit-identical per cluster to
serial runs), and a daemon-shaped service loop
(:mod:`~repro_torch.fleet.service`) adds streaming delta ingestion and a
latency SLO that cuts a tick into valid partial plans.  The load
generator (:mod:`~repro_torch.fleet.loadgen`) drives the sim scenarios
as N concurrent lifecycles.

The planner registers as ``create_planner("fleet")`` (resolved lazily by
:mod:`repro_torch.core.planner`, which keeps the core free of upward
imports).
"""

from .pack import BucketShape, CarryDims, FleetPack
from .planner import FleetPlanner
from .service import FleetService, FleetTickResult
from .loadgen import FleetLoadGen, FleetScenarioEngine

__all__ = [
    "BucketShape", "CarryDims", "FleetPack", "FleetPlanner",
    "FleetService", "FleetTickResult", "FleetLoadGen",
    "FleetScenarioEngine",
]
