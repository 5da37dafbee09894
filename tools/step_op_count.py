#!/usr/bin/env python
"""How many PyTorch operations one planning step of the batch engine
issues, by part of the step.

Runs ``steps`` steps of ``_Chunk`` (``src/repro_torch/core/
equilibrium_batch.py``) on a paper cluster on the CPU and counts the aten
operations each part dispatches under a ``TorchDispatchMode``, views left
out.  On the card each such operation is at least one kernel launch the
host issues, so the count is what the step's host issue rate pays for.
K1's fused selection (``_Chunk.select_rows``, from
``ops.bind_select_rows``) is counted as the one launch
it is on the card: its plain version, which the CPU runs, is left out of
the count (a tree without it, as before the fusion, is counted as it
is).  Prints one JSON line: operations a step in ``select`` (besides
that launch), in ``apply``, and in the whole step with the launch.
``--telemetry`` counts the step as it runs while a tracer is installed
(the device telemetry on), ``--cache`` with the legality cache on,
``--source-block`` at another block of the walk (default 1).
``--sharded`` counts the sharded engine's step (``core/shard.py``,
``_ShardChunk``) on one shard, its window launch as the one launch, and
the collectives a step it calls (identities with no process group, one
collective each in a group).

    PYTHONPATH=src python tools/step_op_count.py [--cluster cluster_a]
        [--telemetry] [--cache] [--source-block 3] [--sharded]

To count another checkout's engine, point ``PYTHONPATH`` at its
``src``.

CPU only, a few seconds; imports torch and the port.
"""

from __future__ import annotations

import argparse
import json
from collections import Counter

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from repro_torch.core import clustergen
from repro_torch.core import equilibrium_batch as eb

#: aten operations that only make a view: no launch on the card
VIEWS = frozenset({"view", "_unsafe_view", "expand", "unsqueeze", "squeeze",
                   "select", "slice", "t", "transpose", "permute", "alias",
                   "as_strided", "detach", "lift_fresh"})


class OpCount(TorchDispatchMode):
    """Counts the non-view aten operations dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._overloadpacket.__name__ not in VIEWS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def count(cluster: str, steps: int, telemetry: bool = False,
          cache: bool = False, source_block: int = 1,
          sharded: bool = False, planner=None) -> dict:
    """Operations a step of ``steps`` steps of a new planner of
    ``cluster`` on the CPU, or of ``planner`` (any device) as given."""
    if planner is None:
        if sharded:
            from repro_torch.core.shard import ShardedBatchPlanner
            make = ShardedBatchPlanner
        else:
            make = eb.BatchPlanner
        planner = make(getattr(clustergen, cluster)(), device="cpu",
                       legality_cache=cache, source_block=source_block)
    planner.sync()
    step = planner._step
    fused = getattr(step, "select_rows", None)
    collectives = Counter()
    comm = getattr(step, "comm", None)
    if comm is not None:
        for name in ("sum", "max", "gather"):
            def counted(t, _f=getattr(comm, name), _name=name):
                collectives[_name] += 1
                return _f(t)
            setattr(comm, name, counted)

    def one_launch(*args, **kwargs):
        with _disable_current_modes():
            return fused(*args, **kwargs)

    select, apply, whole = OpCount(), OpCount(), OpCount()
    select_fn, apply_fn = step.select, step.apply

    def counted_select(*args):
        with select:
            return select_fn(*args)

    def counted_apply(*args):
        with apply:
            return apply_fn(*args)

    if fused is not None:
        step.select_rows = one_launch
    step.select, step.apply = counted_select, counted_apply
    try:
        with whole:             # the nested modes' operations reach it too
            step.run(steps, telemetry)
    finally:
        if comm is not None:
            for name in ("sum", "max", "gather"):
                delattr(comm, name)
        del step.select, step.apply
        if fused is not None:
            step.select_rows = fused
    launches = int(fused is not None)
    out = {"cluster": cluster, "steps": steps, "telemetry": telemetry,
           "legality_cache": cache, "source_block": step.kb,
           "sharded": comm is not None,
           "select_ops_per_step": select.n / steps,
           "select_launches_per_step": launches,
           "apply_ops_per_step": apply.n / steps,
           "run_ops_per_step": whole.n / steps + launches}
    if comm is not None:
        out["collectives_per_step"] = sum(collectives.values()) / steps
        out["collectives"] = dict(collectives)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cluster", default="cluster_a")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--telemetry", action="store_true")
    ap.add_argument("--cache", action="store_true")
    ap.add_argument("--source-block", type=int, default=1)
    ap.add_argument("--sharded", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(1)
    print(json.dumps(count(args.cluster, args.steps, args.telemetry,
                           args.cache, args.source_block, args.sharded)))


if __name__ == "__main__":
    main()
