"""Fault tolerance of the port: failure detection, Equilibrium-planned
recovery, elastic rescale, straggler mitigation (the counterpart of
``src/repro/ft/``).  Host code, NumPy; recovery and rescale plan through
``create_planner("equilibrium")``."""

from .failures import FailureDetector
from .recovery import plan_recovery, RecoveryPlan
from .elastic import plan_rescale, RescalePlan
from .stragglers import StragglerMitigator, simulate_epoch

__all__ = ["FailureDetector", "plan_recovery", "RecoveryPlan",
           "plan_rescale", "RescalePlan", "StragglerMitigator",
           "simulate_epoch"]
