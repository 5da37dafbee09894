"""Core of the port: the cluster model, the legality core, the §3.1
planners, the dense lanes, the device-resident batch engine and the
simulation harness (:mod:`~repro_torch.core.simulate`).  The planner
API (:mod:`repro_torch.core.planner`) is the entry point to every
balancer; ``equilibrium_balance`` / ``balance_fast`` / ``balance_batch``
/ ``mgr_balance`` are deprecated shims kept for compatibility, as in the
reference.  ``__all__`` holds the reference's names and
``planners_in_class``."""

from .cluster import (ClusterDelta, ClusterState, Device, DeviceAddDelta,
                      DeviceOutDelta, GiB, Movement, MovementDelta,
                      PlacementRule, Pool, PoolCreateDelta, PoolGrowthDelta,
                      RuleStep, TiB)
from .crush import build_cluster, place_pg
from .clustergen import PAPER_CLUSTERS, small_test_cluster
from ._compat import balance_batch, balance_fast, equilibrium_balance, \
    mgr_balance
from .dense import DenseState
from .legality import LegalityState
from .equilibrium import EquilibriumConfig
from .equilibrium_batch import BatchPlanner
from .mgr_balancer import MgrBalancerConfig
from .planner import (PlanResult, Planner, PlannerSpec, available_planners,
                      create_planner, get_planner_spec, planners_in_class,
                      register_planner)
from .simulate import (MovementThrottle, SimulationResult, ThrottleConfig,
                       ThrottledReplayResult, compare_balancers, simulate,
                       simulate_throttled)

__all__ = [
    "ClusterState", "Device", "Movement", "PlacementRule", "Pool", "RuleStep",
    "TiB", "GiB", "build_cluster", "place_pg", "PAPER_CLUSTERS",
    "small_test_cluster", "EquilibriumConfig", "equilibrium_balance",
    "DenseState", "balance_fast", "balance_batch", "BatchPlanner",
    "MgrBalancerConfig", "mgr_balance", "LegalityState",
    "Planner", "PlanResult", "PlannerSpec", "register_planner",
    "create_planner", "get_planner_spec", "available_planners",
    "planners_in_class", "ClusterDelta", "MovementDelta", "PoolGrowthDelta",
    "DeviceAddDelta", "DeviceOutDelta", "PoolCreateDelta",
    "SimulationResult", "compare_balancers", "simulate", "MovementThrottle",
    "ThrottleConfig", "ThrottledReplayResult", "simulate_throttled",
]
