"""Deterministic timeline shrinker: event deletion, then parameter
bisection.

Given a serialized timeline (``GeneratedTimeline.to_dict()`` form) and a
predicate ``fails(d) -> bool`` ("does this candidate still reproduce the
original failure?"), :func:`shrink_timeline` greedily minimizes:

1. **event deletion** — ddmin-style: remove halves, then quarters, …,
   then single events, restarting after any success;
2. **tick truncation** — cut ``sim.ticks`` (dropping events past the
   horizon) by bisection toward 1;
3. **parameter bisection** — walk every numeric event field and the
   per-tick move budget toward its floor by repeated halving.

Everything is deterministic: candidates are tried in a fixed order and
results are cached on the candidate's canonical JSON, so the same
failing input always shrinks to the same reproducer.  ``max_evals``
bounds predicate invocations (each one replays whole lifecycles).
"""

from __future__ import annotations

import json
from typing import Callable

from .. import obs as _obs

__all__ = ["shrink_timeline"]

#: per-field floors for the bisection pass (anything not listed is left
#: alone — topology fields like osd_id are identities, not magnitudes)
_FIELD_FLOORS = {
    "count": 1, "duration": 1, "every": 1, "pg_count": 4, "n_osds": 1,
    "bytes_per_tick": 1.0, "stored_bytes": 0.0, "max_moves": -1,
}


def _canon(d: dict) -> str:
    return json.dumps(d, sort_keys=True)


def _with_events(d: dict, events: list) -> dict:
    out = dict(d)
    out["events"] = events
    return out


def _with_ticks(d: dict, ticks: int) -> dict:
    out = dict(d)
    out["sim"] = dict(d["sim"], ticks=ticks)
    out["events"] = [ev for ev in d["events"] if ev["tick"] < ticks]
    return out


def shrink_timeline(d: dict, fails: Callable[[dict], bool],
                    max_evals: int = 300) -> tuple[dict, int]:
    """Minimize ``d`` under ``fails``; returns ``(minimized, evals)``.

    ``d`` itself must fail (callers check before shrinking).  The
    predicate is expected to swallow unrelated crashes (a candidate that
    breaks for a *different* reason is simply not a reproducer).
    """
    cache: dict[str, bool] = {_canon(d): True}
    evals = 0

    def check(cand: dict) -> bool:
        nonlocal evals
        key = _canon(cand)
        if key in cache:
            return cache[key]
        if evals >= max_evals:
            return False
        evals += 1
        _obs.registry().inc("fuzz.shrink.evals")
        cache[key] = bool(fails(cand))
        return cache[key]

    cur = json.loads(_canon(d))

    improved = True
    while improved:
        improved = False

        # 1. event deletion, coarse to fine
        chunk = max(1, len(cur["events"]) // 2)
        while chunk >= 1:
            i = 0
            while i < len(cur["events"]):
                events = cur["events"][:i] + cur["events"][i + chunk:]
                cand = _with_events(cur, events)
                if check(cand):
                    cur = cand
                    improved = True
                else:
                    i += chunk
            chunk //= 2

        # 2. tick truncation by bisection toward 1
        lo, hi = 1, int(cur["sim"]["ticks"])
        while lo < hi:
            mid = (lo + hi) // 2
            cand = _with_ticks(cur, mid)
            if check(cand):
                hi = mid
                cur = cand
                improved = True
            else:
                lo = mid + 1

        # 3. tick compaction: relabel surviving events onto 0..k-1 and
        # cut the horizon to exactly the ticks still used (bisection
        # alone cannot reach this when the last event sits late)
        used = sorted({ev["tick"] for ev in cur["events"]})
        if used:
            remap = {t: i for i, t in enumerate(used)}
            if (len(used) < int(cur["sim"]["ticks"])
                    or any(remap[t] != t for t in used)):
                events = [dict(ev, tick=remap[ev["tick"]])
                          for ev in cur["events"]]
                cand = _with_events(cur, events)
                cand["sim"] = dict(cand["sim"], ticks=len(used))
                if check(cand):
                    cur = cand
                    improved = True

        # 4. numeric parameter bisection toward the field floor
        for idx in range(len(cur["events"])):
            ev = cur["events"][idx]
            for fname in sorted(ev):
                if fname not in _FIELD_FLOORS:
                    continue
                floor = _FIELD_FLOORS[fname]
                while ev[fname] > floor:
                    is_int = isinstance(ev[fname], int)
                    mid = (ev[fname] + floor) / 2
                    nxt = int(mid) if is_int else mid
                    if nxt == ev[fname]:
                        nxt = floor
                    cand_ev = dict(ev, **{fname: nxt})
                    cand = _with_events(
                        cur, cur["events"][:idx] + [cand_ev]
                        + cur["events"][idx + 1:])
                    if check(cand):
                        cur = cand
                        ev = cand_ev
                        improved = True
                    else:
                        break
        # per-tick planning budget
        while int(cur["sim"]["moves_per_tick"]) > 1:
            nxt = max(1, int(cur["sim"]["moves_per_tick"]) // 2)
            cand = dict(cur)
            cand["sim"] = dict(cur["sim"], moves_per_tick=nxt)
            if check(cand):
                cur = cand
                improved = True
            else:
                break

    prov = dict(cur.get("provenance", {}))
    prov["shrunk"] = {"evals": evals, "events": len(cur["events"])}
    cur["provenance"] = prov
    return cur, evals
