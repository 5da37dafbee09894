"""Scenario engine: event-driven cluster lifecycle simulation.

The paper's evaluation is a set of frozen snapshots; this package makes
the cluster move — growth, expansion, failures, throttled backfill — and
ticks any planner registered with :mod:`repro_torch.core.planner` against
the moving target (``BALANCERS`` mirrors that registry).  The port of
:mod:`repro.sim`: the same events, engine, metrics, scenarios and
generator, whose runs give byte-identical metrics JSON; the planners that
run on a device (``equilibrium_batch``, ``equilibrium_jax_legacy``) run on
the CUDA card unless the caller passes ``device="cpu"``.
"""

from .engine import ScenarioEngine, SimConfig
from .events import (DeviceAdd, DeviceFail, DeviceOut, Event,
                     ForeignMovement, HostAdd, PoolCreate, PoolGrowth,
                     RebalanceTick)
from .generate import (PROFILES, FuzzProfile, GeneratedTimeline,
                       fuzz_cluster, generate_timeline, timeline_from_dict)
from .metrics import MetricsCollector
from .scenarios import SCENARIOS, Scenario, register, run_scenario


def __getattr__(name: str):
    # live view of the planner registry (see engine.__getattr__)
    if name == "BALANCERS":
        from . import engine
        return engine.BALANCERS
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "BALANCERS", "ScenarioEngine", "SimConfig", "Event", "PoolGrowth",
    "PoolCreate", "DeviceAdd", "HostAdd", "DeviceOut", "DeviceFail",
    "ForeignMovement", "RebalanceTick", "MetricsCollector", "SCENARIOS",
    "Scenario", "register", "run_scenario", "FuzzProfile", "PROFILES",
    "GeneratedTimeline", "fuzz_cluster", "generate_timeline",
    "timeline_from_dict",
]
