#!/usr/bin/env python3
"""Seconds of ``chip_smoke.py``'s cluster-B planner phases for one tree,
so that two trees can be held against each other within one call.

Imports ``chip_smoke.py`` and the port from ``--tree`` (default: this
checkout), builds cluster B once, and runs that tree's phase 3 (the
untraced cold plan: plan, chunk and set-up seconds), ``cluster_b_warm``
and ``cluster_b_lifecycle`` (both under a tracer, so the batch engine's
device telemetry runs where the tree has it).  Prints one JSON line:

    python3 tools/cluster_b_phases.py [--tree DIR] [--label NAME]

Run parent, change, change, parent in one call: the host's speed moves
by more than the difference between two calls.  Needs one card; about
two minutes a tree on an H100, the first run of a tree with its K1
build.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("cluster_b_phases: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    t0 = time.perf_counter()
    built = cs.build_cluster_b()
    full = cs.phase_full(card, built=built)
    warm = cs.phase_warm(card, built[0])
    life = cs.phase_lifecycle(card, built[0])
    steps = warm["steps"]
    out = {"label": args.label, "tree": str(tree), "card": card,
           "phase3": {k: full[k] for k in ("plan_s", "chunks_s", "setup_s")},
           "warm": {"plan_s": sum(s["plan_s"] for s in steps),
                    "chunks_s": sum(s["chunks_s"] for s in steps),
                    "absorb_s": sum(s["absorb_s"] for s in steps)},
           "lifecycle": {"seconds_batch": life["seconds_batch"],
                         "seconds_host": life["seconds_host"]},
           "seconds": time.perf_counter() - t0}
    print(json.dumps({"cluster_b_phases": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
