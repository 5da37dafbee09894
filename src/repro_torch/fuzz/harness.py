"""Differential lanes + oracles for generated lifecycles.

A *lane* is one full scenario run of a timeline with one planner engine,
instrumented so the §3.1 correctness claims are re-checked from outside
the engine: every planned move is replayed on a pre-plan copy through
:meth:`ClusterState.move_is_legal` / :meth:`apply` (code that shares
nothing with :mod:`repro_torch.core.legality`'s vectorized expressions),
the replayed utilization variance must be non-increasing, and the
movement throttle's byte ledger must balance every tick.
:func:`run_timeline` then compares lanes pairwise (bitwise move streams,
byte-identical metrics JSON), bounds warm-engine rebuilds, and replays
the serialized timeline to prove seed ⇒ bytes.

``device`` reaches the lanes that run on one (``equilibrium_batch``,
``equilibrium_batch_sharded``, ``equilibrium_jax_legacy``, ``fleet``):
``None`` is the CUDA card, and those lanes raise without one; ``"cpu"``
runs them on their kernels' plain versions.  The host lanes ignore it.
:func:`sharded_lane` is one rank's run of the sharded lane in a process
group (the CLI's ``--shard-subprocess``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..core.cluster import ClusterState
from ..core.planner import planners_in_class
from ..sim.engine import ScenarioEngine
from ..sim.generate import GeneratedTimeline, timeline_from_dict
from .. import obs as _obs

__all__ = ["OracleFailure", "LaneResult", "run_lane", "run_lifecycle",
           "run_timeline", "failure_signature", "EQUIVALENCE_CLASS",
           "BASELINE_LANES"]

EQUIVALENCE_CLASS = "equilibrium"

#: lanes run with the reduced oracle set (legality + conservation only):
#: the mgr baseline is size-blind and variance may lawfully worsen, and
#: neither baseline is expected to agree with the equilibrium class
BASELINE_LANES = ("mgr", "none")

#: how far the replayed ``np.var`` recompute may drift above the
#: engines' moment-maintained variance on an accepted move
_VARIANCE_EPS = 1e-12


class OracleFailure(AssertionError):
    """One oracle violated; ``oracle`` names which (stable across runs,
    so the shrinker can insist the minimized timeline fails the *same*
    way)."""

    def __init__(self, oracle: str, detail: str):
        self.oracle = oracle
        self.detail = detail
        _obs.registry().inc("fuzz.oracle_failures", oracle=oracle)
        super().__init__(f"[{oracle}] {detail}")


def failure_signature(exc: BaseException) -> str | None:
    """The oracle name if ``exc`` is an oracle failure, else None."""
    return exc.oracle if isinstance(exc, OracleFailure) else None


@dataclass
class LaneResult:
    engine: str
    moves: list = field(default_factory=list)     # (pg, slot, src, dst) ...
    metrics_json: str = ""
    rebuilds: int = 0
    planned_moves: int = 0


class _ReplayPlanner:
    """Planner proxy implementing the legality + variance oracles.

    Each ``plan()`` snapshots the state *before* the inner planner runs
    (planners apply their own moves), then replays the returned move
    list on the snapshot: an illegal or stale move raises immediately,
    and — for equivalence-class lanes — the independently recomputed
    utilization variance must never increase (§3.1 acceptance).  The
    snapshot is a :meth:`ClusterState.copy`, which starts with no
    subscribers, so the replay's ``apply`` never reaches a warm planner
    bound to the live state.
    """

    def __init__(self, inner, engine: str, check_variance: bool,
                 headroom: float = 0.0):
        self._inner = inner
        self._engine = engine
        self._check_variance = check_variance
        self._headroom = headroom
        self.moves: list[tuple] = []
        self.name = getattr(inner, "name", engine)

    def plan(self, state: ClusterState, **kwargs):
        pre = state.copy()
        result = self._inner.plan(state, **kwargs)
        prev = pre.utilization_variance()
        for mv in result.moves:
            if not pre.move_is_legal(mv.pg, mv.slot, mv.dst_osd,
                                     headroom=self._headroom):
                raise OracleFailure(
                    "legality",
                    f"{self._engine}: planned illegal move pg={mv.pg} "
                    f"slot={mv.slot} {mv.src_osd}->{mv.dst_osd}")
            try:
                pre.apply(mv)
            except Exception as exc:
                raise OracleFailure(
                    "legality",
                    f"{self._engine}: move not applicable ({exc}): "
                    f"pg={mv.pg} slot={mv.slot} "
                    f"{mv.src_osd}->{mv.dst_osd}") from exc
            if self._check_variance:
                v = pre.utilization_variance()
                if v > prev + _VARIANCE_EPS:
                    raise OracleFailure(
                        "variance",
                        f"{self._engine}: variance rose {prev!r} -> {v!r} "
                        f"on pg={mv.pg} slot={mv.slot} "
                        f"{mv.src_osd}->{mv.dst_osd}")
                prev = v
            self.moves.append((mv.pg, mv.slot, mv.src_osd, mv.dst_osd,
                               float(mv.size)))
        return result

    def observe(self, delta) -> bool:
        return self._inner.observe(delta)

    def reset(self) -> None:
        self._inner.reset()


#: engines that keep warm device state — their dense mirror must be
#: built at most once per lifecycle (delta absorption closes the rest)
_WARM_ENGINES = {"equilibrium_batch", "equilibrium_batch_sharded", "fleet"}


def run_lifecycle(state: ClusterState, events: list, cfg, engine: str,
                  equivalence_checks: bool = True,
                  device=None, planner_kwargs: dict | None = None
                  ) -> LaneResult:
    """Run one ``(state, events, cfg)`` lifecycle with one engine under
    the in-lane oracles (``cfg.balancer`` is set to ``engine``'s by the
    caller).  :func:`run_lane` builds these from a generated timeline;
    a lifecycle of any size, a production cluster's included, goes
    through the same oracles here.  ``planner_kwargs`` reach the
    planner's constructor beside the engine's own (the batch engine's
    ``legality_cache`` or ``pipeline``, say)."""
    from ..core.equilibrium_batch import dense_rebuild_count

    inner = ScenarioEngine._make_planner(cfg, device, **(planner_kwargs
                                                         or {}))
    # equivalence lanes are replayed under the lane's configured capacity
    # headroom; baselines (mgr/none) don't honor that knob, so replay at 0
    headroom = cfg.equilibrium.headroom if equivalence_checks else 0.0
    proxy = _ReplayPlanner(inner, engine, check_variance=equivalence_checks,
                           headroom=headroom)
    reg = _obs.registry()
    reg.inc("fuzz.lanes", engine=engine)
    rebuilds0 = dense_rebuild_count()
    sim = ScenarioEngine(state, events, cfg, planner=proxy)
    for t in range(cfg.ticks):
        sim.step(t)
        try:
            sim.throttle.check_conservation()
        except AssertionError as exc:
            raise OracleFailure(
                "conservation", f"{engine}: tick {t}: {exc}") from exc
    rebuilds = dense_rebuild_count() - rebuilds0
    if engine in _WARM_ENGINES and rebuilds > 1:
        raise OracleFailure(
            "rebuild", f"{engine}: {rebuilds} dense rebuilds in one "
            f"lifecycle (absorption must hold it to at most 1)")
    return LaneResult(
        engine=engine, moves=proxy.moves,
        metrics_json=json.dumps(sim.metrics.to_dict(), sort_keys=True),
        rebuilds=rebuilds, planned_moves=len(proxy.moves))


def run_lane(tl: GeneratedTimeline, engine: str,
             equivalence_checks: bool = True, device=None) -> LaneResult:
    """Run one timeline with one engine under the in-lane oracles."""
    state, events, cfg = tl.build(engine)
    return run_lifecycle(state, events, cfg, engine,
                         equivalence_checks=equivalence_checks,
                         device=device)


def sharded_lane(timeline: dict) -> tuple[list, str]:
    """One rank's run of a serialized timeline through the sharded lane
    on the CPU, one torch thread a rank (the fuzz CLI's
    ``--shard-subprocess``, in each rank of a ``spawn_ranks`` group):
    (its moves, its metrics JSON)."""
    import torch
    torch.set_num_threads(1)
    lane = run_lane(timeline_from_dict(timeline),
                    "equilibrium_batch_sharded", device="cpu")
    return lane.moves, lane.metrics_json


def run_timeline(tl: GeneratedTimeline, engines: tuple[str, ...] | None = None,
                 baseline_lanes: tuple[str, ...] = BASELINE_LANES,
                 replay_check: bool = True,
                 device=None) -> dict[str, LaneResult]:
    """Run every lane of one timeline and apply the cross-lane oracles.

    ``engines=None`` enumerates the registered ``"equilibrium"``
    equivalence class.  Raises :class:`OracleFailure` on the first
    violated oracle; returns the per-lane results otherwise.
    """
    reg = _obs.registry()
    reg.inc("fuzz.timelines")
    if engines is None:
        engines = planners_in_class(EQUIVALENCE_CLASS)
    if not engines:
        raise ValueError("no engines to run")

    lanes: dict[str, LaneResult] = {}
    for engine in engines:
        lanes[engine] = run_lane(tl, engine, equivalence_checks=True,
                                 device=device)
        reg.inc("fuzz.oracle_checks", oracle="legality")
        reg.inc("fuzz.oracle_checks", oracle="variance")
        reg.inc("fuzz.oracle_checks", oracle="conservation")

    ref_name = engines[0]
    ref = lanes[ref_name]
    for engine, lane in lanes.items():
        reg.inc("fuzz.oracle_checks", oracle="agreement")
        if lane.moves != ref.moves:
            raise OracleFailure(
                "agreement",
                f"{engine} vs {ref_name}: move streams diverge at index "
                f"{_first_divergence(lane.moves, ref.moves)} "
                f"({len(lane.moves)} vs {len(ref.moves)} moves)")
        if lane.metrics_json != ref.metrics_json:
            raise OracleFailure(
                "agreement",
                f"{engine} vs {ref_name}: metrics JSON differs despite "
                f"identical move streams")

    for engine in baseline_lanes:
        lanes[engine] = run_lane(tl, engine, equivalence_checks=False,
                                 device=device)

    if replay_check:
        reg.inc("fuzz.oracle_checks", oracle="replay")
        resurrected = timeline_from_dict(
            json.loads(json.dumps(tl.to_dict())))
        again = run_lane(resurrected, ref_name, equivalence_checks=True,
                         device=device)
        if again.metrics_json != ref.metrics_json:
            raise OracleFailure(
                "replay",
                f"{ref_name}: serialized-and-replayed timeline produced "
                f"different metrics JSON")
    return lanes


def _first_divergence(a: list, b: list) -> int:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return min(len(a), len(b))
