"""Equilibrium-balanced paged KV-cache pool (the counterpart of
``src/repro/serve/paged_kv.py``).

Serving capacity is min-gated exactly like Ceph pools: a new request is
admitted only if some chip's page pool has room for its KV pages, so the
*fullest* chip bounds admissible context length — the paper's premise,
byte for byte.  Mapping:

* OSD        → chip page pool (capacity = page_budget × page_bytes)
* PG         → one live sequence
* PG shard   → that sequence's KV residency on a chip (replication 1 for
               pure DP serving; R>1 models TP-group co-residency)
* shard size → pages(seq_len) × page_bytes — grows as the sequence decodes
               (this is the *size-aware* signal: long sequences are the
               "large shards" Equilibrium moves first)

``rebalance()`` emits explicit sequence migrations (the KV bytes to copy
over the interconnect) from fullest to emptiest chips — same acceptance tests as the
paper (§3.1): legality, per-chip sequence-count criterion, strict variance
decrease.  ``admit()`` places new sequences on the emptiest legal chip
(CRUSH-style weighted choice is what vLLM-style engines do implicitly;
emptiest-first is our balancer-aware improvement).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import (ClusterState, Device, EquilibriumConfig, Movement,
                    PlacementRule, Pool)
from ..core.planner import create_planner


@dataclass(frozen=True)
class PagedKVSpec:
    n_chips: int
    page_tokens: int = 128
    page_bytes: float = 128 * 2 * 8 * 128 * 2     # tokens·2(kv)·heads·dh·bf16
    pages_per_chip: int = 4096
    chips_per_host: int = 4


class PagedKVPool:
    """Tracks sequence→chip placement + page accounting; plans migrations."""

    def __init__(self, spec: PagedKVSpec):
        self.spec = spec
        self.devices = [Device(id=i,
                               capacity=spec.pages_per_chip * spec.page_bytes,
                               device_class="hbm",
                               host=f"host{i // spec.chips_per_host:04d}")
                        for i in range(spec.n_chips)]
        self.rule = PlacementRule.replicated(1, "osd", "hbm")
        self.seq_chip: dict[int, int] = {}
        self.seq_len: dict[int, int] = {}
        self._next_id = 0

    # -- accounting ----------------------------------------------------------

    def pages_of(self, seq_len: int) -> int:
        return -(-seq_len // self.spec.page_tokens)

    def bytes_of(self, seq_len: int) -> float:
        return self.pages_of(seq_len) * self.spec.page_bytes

    def chip_used_bytes(self) -> np.ndarray:
        used = np.zeros(self.spec.n_chips)
        for sid, chip in self.seq_chip.items():
            used[chip] += self.bytes_of(self.seq_len[sid])
        return used

    def utilization(self) -> np.ndarray:
        cap = np.array([d.capacity for d in self.devices])
        return self.chip_used_bytes() / cap

    # -- admission / growth ---------------------------------------------------

    def admit(self, seq_len: int) -> int | None:
        """Place a new sequence on the emptiest chip with room; None if the
        pool is full (the min-gated capacity in action)."""
        need = self.bytes_of(seq_len)
        used = self.chip_used_bytes()
        cap = np.array([d.capacity for d in self.devices])
        order = np.argsort(used / cap, kind="stable")
        for chip in order:
            if used[chip] + need <= cap[chip]:
                sid = self._next_id
                self._next_id += 1
                self.seq_chip[sid] = int(chip)
                self.seq_len[sid] = seq_len
                return sid
        return None

    def extend(self, sid: int, new_tokens: int = 1) -> bool:
        """Grow a sequence; returns False if its chip is out of pages (the
        caller should rebalance or evict)."""
        chip = self.seq_chip[sid]
        new_len = self.seq_len[sid] + new_tokens
        used = self.chip_used_bytes()
        delta = self.bytes_of(new_len) - self.bytes_of(self.seq_len[sid])
        if used[chip] + delta > self.devices[chip].capacity:
            return False
        self.seq_len[sid] = new_len
        return True

    def release(self, sid: int) -> None:
        self.seq_chip.pop(sid, None)
        self.seq_len.pop(sid, None)

    # -- Equilibrium rebalancing ----------------------------------------------

    def _cluster_state(self) -> tuple[ClusterState, dict]:
        seq_ids = sorted(self.seq_chip)
        pg_of_seq = {sid: i for i, sid in enumerate(seq_ids)}
        pool = Pool(0, "kv", max(len(seq_ids), 1), self.rule,
                    stored_bytes=sum(self.bytes_of(self.seq_len[s])
                                     for s in seq_ids))
        acting = {(0, pg_of_seq[s]): [self.seq_chip[s]] for s in seq_ids}
        sizes = {(0, pg_of_seq[s]): self.bytes_of(self.seq_len[s])
                 for s in seq_ids}
        state = ClusterState(self.devices, [pool], acting, sizes)
        return state, {v: k for k, v in pg_of_seq.items()}

    def rebalance(self, cfg: EquilibriumConfig | None = None
                  ) -> list[tuple[int, int, int, float]]:
        """Equilibrium pass → [(seq_id, src_chip, dst_chip, bytes)]."""
        if not self.seq_chip:
            return []
        state, seq_of_pg = self._cluster_state()
        # per-chip sequence-count ideal is meaningless for serving; disable
        # the count criterion with a generous slack, keep variance descent.
        cfg = cfg or EquilibriumConfig(k=8, count_slack=1e9)
        movements = create_planner("equilibrium", cfg=cfg).plan(state).moves
        plan = []
        for mv in movements:
            sid = seq_of_pg[mv.pg[1]]
            plan.append((sid, mv.src_osd, mv.dst_osd, mv.size))
            self.seq_chip[sid] = mv.dst_osd
        return plan

    def migration_bytes(self, plan) -> float:
        return float(sum(p[3] for p in plan))
