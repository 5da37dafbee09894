"""Straggler mitigation for the data/compute pipeline (the counterpart
of ``src/repro/ft/stragglers.py``).

Deadline-based backup dispatch (MapReduce-style speculative execution,
adapted to a synchronous-training fleet): work items (data shards,
checkpoint writes, eval splits) are dispatched to hosts; when a host's
projected completion exceeds the p-quantile deadline, the item is
duplicated onto the fastest idle host and the first finisher wins.  The
simulator is deterministic given the per-host throughput model so tests
can assert the speedup.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class StragglerMitigator:
    n_hosts: int
    backup_quantile: float = 0.95
    max_backups_frac: float = 0.15

    def plan_backups(self, eta: np.ndarray) -> list[tuple[int, int]]:
        """eta[i] = projected seconds for item i on its current host.
        Returns [(item, reason_rank)] for items to duplicate."""
        if len(eta) == 0:
            return []
        deadline = float(np.quantile(eta, self.backup_quantile))
        order = np.argsort(-eta)
        budget = max(1, int(self.max_backups_frac * len(eta)))
        picks = [int(i) for i in order[:budget] if eta[i] > deadline]
        return [(i, r) for r, i in enumerate(picks)]


def simulate_epoch(item_bytes: np.ndarray, host_of: np.ndarray,
                   host_speed: np.ndarray, mitigator: StragglerMitigator | None,
                   seed: int = 0) -> dict:
    """Simulate one epoch of shard processing.

    Without mitigation, epoch time = max over hosts of Σ bytes/speed.
    With mitigation, flagged items can run on the fastest
    under-loaded host; first finisher wins.
    """
    n_hosts = len(host_speed)
    load = np.zeros(n_hosts)
    for b, h in zip(item_bytes, host_of):
        load[h] += b
    base_time = load / host_speed
    epoch_plain = float(base_time.max())

    if mitigator is None:
        return {"epoch_seconds": epoch_plain, "backups": 0}

    # per-item ETA on its host (proportional share of the host's queue)
    eta = np.array([load[h] / host_speed[h] for h in host_of])
    backups = mitigator.plan_backups(eta)
    load2 = load.copy()
    moved = 0
    for item, _ in backups:
        src = host_of[item]
        # fastest host by projected finish after accepting the item
        cand = np.argmin((load2 + item_bytes[item]) / host_speed)
        if cand == src:
            continue
        finish_src = load2[src] / host_speed[src]
        finish_dst = (load2[cand] + item_bytes[item]) / host_speed[cand]
        if finish_dst < finish_src:          # backup wins
            load2[src] -= item_bytes[item]
            load2[cand] += item_bytes[item]
            moved += 1
    epoch_mitigated = float((load2 / host_speed).max())
    return {"epoch_seconds": epoch_mitigated,
            "epoch_seconds_unmitigated": epoch_plain,
            "backups": moved,
            "speedup": epoch_plain / max(epoch_mitigated, 1e-12)}
