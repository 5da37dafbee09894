"""Core of the port: the cluster model, the legality core, the §3.1
planners, the dense lanes and the device-resident batch engine.  The
planner API (:mod:`repro_torch.core.planner`) is the entry point to
every balancer."""

from .cluster import (ClusterDelta, ClusterState, Device, DeviceAddDelta,
                      DeviceOutDelta, GiB, Movement, MovementDelta,
                      PlacementRule, Pool, PoolCreateDelta, PoolGrowthDelta,
                      RuleStep, TiB)
from .crush import build_cluster, place_pg
from .clustergen import PAPER_CLUSTERS, small_test_cluster
from .dense import DenseState
from .equilibrium import EquilibriumConfig
from .mgr_balancer import MgrBalancerConfig
from .planner import (PlanResult, Planner, PlannerSpec, available_planners,
                      create_planner, get_planner_spec, planners_in_class,
                      register_planner)

__all__ = [
    "ClusterState", "Device", "Movement", "PlacementRule", "Pool", "RuleStep",
    "TiB", "GiB", "build_cluster", "place_pg", "PAPER_CLUSTERS",
    "small_test_cluster", "EquilibriumConfig", "DenseState",
    "MgrBalancerConfig",
    "Planner", "PlanResult", "PlannerSpec", "register_planner",
    "create_planner", "get_planner_spec", "available_planners",
    "planners_in_class", "ClusterDelta", "MovementDelta", "PoolGrowthDelta",
    "DeviceAddDelta", "DeviceOutDelta", "PoolCreateDelta",
]
