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

    PYTHONPATH=src python tools/step_op_count.py [--cluster cluster_a]

To count another checkout's engine, point ``PYTHONPATH`` at its
``src``.

CPU only, a few seconds; imports torch and the port.
"""

from __future__ import annotations

import argparse
import json

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


def count(cluster: str, steps: int) -> dict:
    planner = eb.BatchPlanner(getattr(clustergen, cluster)(), device="cpu")
    planner.sync()
    step = planner._step
    fused = getattr(step, "select_rows", None)

    def one_launch(*args):
        with _disable_current_modes():
            return fused(*args)

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
    with whole:                 # the nested modes' operations reach it too
        step.run(steps)
    launches = int(fused is not None)
    return {"cluster": cluster, "steps": steps,
            "select_ops_per_step": select.n / steps,
            "select_launches_per_step": launches,
            "apply_ops_per_step": apply.n / steps,
            "run_ops_per_step": whole.n / steps + launches}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cluster", default="cluster_a")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(1)
    print(json.dumps(count(args.cluster, args.steps)))


if __name__ == "__main__":
    main()
