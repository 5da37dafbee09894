"""Input pipeline (the counterpart of ``src/repro/data/pipeline.py``).

* :class:`SyntheticTokenSource` — deterministic per-shard token streams
  (seeded PRNG), standing in for tokenized corpus files; shapes and
  sharding match what a real file-backed source would produce.
* :func:`assign_shards` — file-shard → loader-host assignment planned by
  the Equilibrium balancer over heterogeneous loader capacities (bytes of
  local cache/IO budget), so no loader host gates epoch time (the
  slowest/fullest loader is the "fullest OSD" of the pipeline).
* :class:`TokenLoader` — double-buffered prefetch iterator producing
  global batches as host NumPy arrays; moving them to the card is the
  trainer's step.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from ..core import (ClusterState, Device, EquilibriumConfig, PlacementRule,
                    Pool)
from ..core.crush import build_cluster
from ..core.planner import create_planner


@dataclass(frozen=True)
class DataShard:
    id: int
    n_tokens: int
    seed: int

    @property
    def nbytes(self) -> int:
        return self.n_tokens * 4


@dataclass
class ShardAssignment:
    host_of: dict[int, int]              # shard id -> host index
    movements_bytes: float
    utilization: np.ndarray

    def shards_of(self, host: int) -> list[int]:
        return sorted(s for s, h in self.host_of.items() if h == host)


def assign_shards(shards: list[DataShard], host_capacities: list[float],
                  seed: int = 0) -> ShardAssignment:
    """CRUSH-style initial spread + Equilibrium smoothing."""
    devices = [Device(id=i, capacity=c, device_class="loader",
                      host=f"loader{i:03d}")
               for i, c in enumerate(host_capacities)]
    pool = Pool(0, "data", len(shards),
                PlacementRule.replicated(1, "osd", "loader"),
                stored_bytes=float(sum(s.nbytes for s in shards)))
    state = build_cluster(devices, [pool], seed=seed, size_jitter=0.0)
    sizes = {(0, s.id): float(s.nbytes) for s in shards}
    state = ClusterState(devices, [pool], state.acting, sizes)
    moves = create_planner(
        "equilibrium",
        cfg=EquilibriumConfig(k=8, count_slack=1e9)).plan(state).moves
    host_of = {pg[1]: state.idx(osds[0])
               for pg, osds in state.acting.items()}
    return ShardAssignment(host_of, float(sum(m.size for m in moves)),
                           state.utilization())


class SyntheticTokenSource:
    """Deterministic tokens per shard: shard i yields its ``n_tokens`` from
    PRNG(seed, i) — reproducible across restarts (checkpointable cursor)."""

    def __init__(self, shards: list[DataShard], vocab_size: int,
                 seq_len: int):
        self.shards = {s.id: s for s in shards}
        self.vocab = vocab_size
        self.seq_len = seq_len

    def sequences_in(self, shard_id: int) -> int:
        return self.shards[shard_id].n_tokens // (self.seq_len + 1)

    def read(self, shard_id: int, index: int) -> tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) for sequence ``index`` of a shard."""
        s = self.shards[shard_id]
        rng = np.random.default_rng((s.seed, shard_id, index))
        seq = rng.integers(0, self.vocab, self.seq_len + 1, dtype=np.int32)
        return seq[:-1], seq[1:]


class TokenLoader:
    """Double-buffered global-batch iterator with a checkpointable cursor.

    ``state_dict()``/``load_state_dict()`` make the input pipeline part of
    the fault-tolerance story: on restart the loader resumes mid-epoch at
    the exact cursor recorded in the training checkpoint.
    """

    def __init__(self, source: SyntheticTokenSource, shard_order: list[int],
                 global_batch: int, prefetch: int = 2):
        self.source = source
        self.shard_order = shard_order
        self.global_batch = global_batch
        self.cursor = 0                       # global sequence index
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # flat index space over (shard, seq)
        self._index: list[tuple[int, int]] = []
        for sid in shard_order:
            for j in range(source.sequences_in(sid)):
                self._index.append((sid, j))

    def __len__(self) -> int:
        return len(self._index) // self.global_batch

    def _build(self, at: int):
        toks, labs = [], []
        for k in range(self.global_batch):
            sid, j = self._index[(at + k) % len(self._index)]
            t, l = self.source.read(sid, j)
            toks.append(t)
            labs.append(l)
        return {"tokens": np.stack(toks), "labels": np.stack(labs)}

    def _worker(self):
        at = self.cursor
        while not self._stop.is_set():
            batch = self._build(at)
            self._q.put((at, batch))
            at += self.global_batch

    def __iter__(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def __next__(self):
        at, batch = self._q.get()
        self.cursor = at + self.global_batch
        return batch

    def close(self):
        self._stop.set()
        if self._thread is not None:
            while not self._q.empty():
                self._q.get_nowait()

    def state_dict(self) -> dict:
        return {"cursor": self.cursor, "shard_order": self.shard_order}

    def load_state_dict(self, state: dict) -> None:
        self.cursor = int(state["cursor"])
        self.shard_order = list(state["shard_order"])
