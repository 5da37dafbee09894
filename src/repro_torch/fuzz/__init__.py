"""Differential lifecycle fuzzing: the port of the JAX package's fuzzer.

One generated timeline (:mod:`repro_torch.sim.generate`) is run through
every registered planner engine in the ``"equilibrium"`` equivalence
class — plus baseline lanes with reduced oracles — and the runs are
checked against each other and against independent replays:

* **legality** — every planner move replayed through
  :meth:`ClusterState.move_is_legal` + :meth:`apply` on a pre-plan copy
  (a code path independent of :mod:`repro_torch.core.legality`'s
  vectorized expressions, so a broken predicate cannot hide itself);
* **variance** — replayed utilization variance never increases across a
  planner's accepted moves (§3.1 acceptance);
* **agreement** — bitwise-identical move streams and byte-identical
  metrics JSON across every equivalence-class engine;
* **rebuild** — warm engines build their dense mirror at most once per
  lifecycle (delta absorption covers every generated event class);
* **conservation** — the movement throttle's byte ledger balances at
  every tick (:meth:`MovementThrottle.check_conservation`);
* **replay** — serializing the timeline and re-running it reproduces
  the metrics JSON byte-for-byte.

The lanes that run on a device (``equilibrium_batch`` and
``equilibrium_jax_legacy``) run on the CUDA card unless the caller
passes ``device="cpu"``.  On failure, :mod:`repro_torch.fuzz.shrink`
minimizes the timeline (event deletion, then parameter bisection —
deterministic) and :mod:`repro_torch.fuzz.corpus` files it under
``tests/regressions/``.  :mod:`repro_torch.fuzz.mutate` hosts the
intentionally-broken legality predicates that prove the harness can
catch a broken planner.  ``python -m repro_torch.fuzz`` is the CLI.
"""

from .harness import (LaneResult, OracleFailure, failure_signature,
                      run_lane, run_timeline)
from .corpus import corpus_dir, iter_corpus, load_timeline, save_timeline
from .mutate import MUTATIONS, mutated
from .shrink import shrink_timeline

__all__ = [
    "LaneResult", "OracleFailure", "failure_signature", "run_lane",
    "run_timeline", "corpus_dir", "iter_corpus", "load_timeline",
    "save_timeline", "MUTATIONS", "mutated", "shrink_timeline",
]
