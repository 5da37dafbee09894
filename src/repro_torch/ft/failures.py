"""Heartbeat-based failure detection (control-plane simulation; the
counterpart of ``src/repro/ft/failures.py``).

On a real fleet this runs on the coordinator: workers heartbeat every few
seconds; a device missing ``timeout`` seconds of heartbeats is declared
failed and the recovery planner (recovery.py) is invoked with the surviving
membership.  The simulation is deterministic and clock-injected so tests
can drive arbitrary failure schedules.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class FailureDetector:
    members: set[str]
    timeout: float = 10.0
    last_seen: dict[str, float] = field(default_factory=dict)
    declared_failed: set[str] = field(default_factory=set)

    def heartbeat(self, member: str, now: float) -> None:
        if member in self.declared_failed:
            return                       # rejoin goes through admit()
        self.last_seen[member] = now

    def admit(self, member: str, now: float) -> None:
        """(Re)join: elastic scale-up or recovered node."""
        self.members.add(member)
        self.declared_failed.discard(member)
        self.last_seen[member] = now

    def sweep(self, now: float) -> set[str]:
        """Returns newly failed members."""
        newly = set()
        for m in self.members:
            if m in self.declared_failed:
                continue
            seen = self.last_seen.get(m)
            if seen is None or now - seen > self.timeout:
                self.declared_failed.add(m)
                newly.add(m)
        return newly

    @property
    def alive(self) -> set[str]:
        return self.members - self.declared_failed
