#!/usr/bin/env python
"""K1's fused selection at cluster B's first step, in alternating turns
of two or more checkouts on one card.

Each turn runs one checkout in a process of its own (two checkouts'
``repro_torch`` cannot share a process): the batch engine's carry of
cluster B (``cluster_b()``, built once and handed to every turn as its
plain dict), its first step's ``sources()``, and ``select_rows`` bound
to that carry as the planner binds it, timed as ``chip_smoke.py``'s
phase 1 times it: ``ms`` (CUDA events around calls the host issues back
to back) and ``device_ms`` (calls queued behind a sleep kernel), three
of each, with the device vectors staged in shared memory (the main
path's launch at this size) and, as ``dm_ms`` and ``dm_device_ms``, read
from device memory (``smem_limit=0``).  Odd turns take the checkouts
in the order given, even turns in reverse.  Prints one JSON line a
checkout and turn, then one with each checkout's medians and ranges
over its turns.

    python3 tools/k1_turns.py PARENT_CHECKOUT . [--turns 4]

Needs one CUDA card; each checkout builds its kernels into its own
``build/`` at first use.  Imports torch and each checkout's
``repro_torch`` and ``chip_smoke``.
"""

from __future__ import annotations

import argparse
import json
import pickle
import statistics
import subprocess
import sys
from pathlib import Path

#: where the pickled cluster waits for the turns (a directory that
#: ``.gitignore`` lists)
CLUSTER = Path(__file__).resolve().parent.parent / "build" / \
    "k1_turns_cluster_b.pkl"


def prepare(tree: Path, path: Path) -> None:
    """Cluster B as a plain dict, pickled to ``path``."""
    sys.path[:0] = [str(tree / "src")]
    from repro_torch.core.clustergen import cluster_b
    path.write_bytes(pickle.dumps(cluster_b().to_plain()))


def one_turn(tree: Path, path: Path) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke as cs
    from repro_torch.core import ClusterState
    from repro_torch.core.equilibrium_batch import BatchPlanner
    from repro_torch.kernels import select_move

    state = ClusterState.from_plain(pickle.loads(path.read_bytes()))
    planner = BatchPlanner(state, device="cuda")
    planner.sync()
    step = planner._step
    _, src_order, n_avail = step.sources()
    staged, apart = (select_move.SelectRows(step.cap_lim, step.dyn,
                                            step.const, step.scal,
                                            smem_limit=limit)
                     for limit in (None, 0))

    def fn():
        return staged(src_order, n_avail)

    def dm():
        return apart(src_order, n_avail)
    return {"tree": str(tree),
            "shape": {"k": step.k, "R": step.r_cap,
                      "n": step.dev_iota.shape[0]},
            "ms": [cs.time_cuda(fn) for _ in range(3)],
            "device_ms": [cs.device_ms(fn, 50) for _ in range(3)],
            "dm_ms": [cs.time_cuda(dm) for _ in range(3)],
            "dm_device_ms": [cs.device_ms(dm, 50) for _ in range(3)]}


def summary(rows: list[dict]) -> dict:
    out = {}
    for tree in dict.fromkeys(r["tree"] for r in rows):
        mine = [r for r in rows if r["tree"] == tree]
        got = {key: [statistics.median(r[key]) for r in mine]
               for key in ("ms", "device_ms", "dm_ms", "dm_device_ms")}
        out[tree] = {key: {"median": statistics.median(v), "min": min(v),
                           "max": max(v)} for key, v in got.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--one", type=Path, metavar="CLUSTER",
                    help="run one turn of the single checkout given, in "
                         "this process, on the pickled cluster")
    ap.add_argument("--prepare", type=Path, metavar="CLUSTER",
                    help="pickle cluster B's plain dict there and stop")
    args = ap.parse_args()
    if args.prepare:
        prepare(args.trees[0].resolve(), args.prepare)
        return 0
    if args.one:
        print(json.dumps(one_turn(args.trees[0].resolve(), args.one)),
              flush=True)
        return 0
    rows = []
    CLUSTER.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([sys.executable, __file__, "--prepare", str(CLUSTER),
                    str(args.trees[0])], check=True, timeout=600)
    for turn in range(args.turns):
        order = args.trees if turn % 2 == 0 else args.trees[::-1]
        for tree in order:
            run = subprocess.run([sys.executable, __file__, "--one",
                                  str(CLUSTER), str(tree)],
                                 capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                print(run.stderr[-2000:], file=sys.stderr)
                return run.returncode
            rows.append(json.loads(run.stdout.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
    CLUSTER.unlink()
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
