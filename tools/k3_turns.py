#!/usr/bin/env python
"""K3's times in alternating turns of two or more checkouts on one card.

Each turn runs one checkout in a process of its own (two checkouts'
``repro_torch`` cannot share a process): K3 (``ssd_scan_fwd``, bf16,
chunk 128, B 1, T 4096, G 1, P 64) at zamba2-7b's width (112 heads, N
64) and at mamba2-2.7b's (80 heads, N 128), each timed as
``chip_smoke.py`` times it: ``ms`` (CUDA events around calls the host
issues back to back) three times, ``device_ms`` (calls queued behind a
sleep kernel) and the host's microseconds to issue one call.  Odd turns
take the checkouts in the order given, even turns in reverse.  Prints
one JSON line a checkout and turn, then one with each checkout's
medians and ranges over its turns and, from ``cuobjdump -sass`` of each
checkout's library, the instruction count of each tensor-core
instantiation (by chunk and state width, N 64 where the kernel has no
N parameter) and the instructions in which the first checkout's
differ from each other's.

    python3 tools/k3_turns.py PARENT_CHECKOUT . [--turns 6]

Needs one CUDA card; each checkout builds its kernels into its own
``build/`` at first use.  Imports torch and each checkout's
``repro_torch`` and ``chip_smoke``.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

#: (name, heads, N) of the shapes timed
SHAPES = (("zamba2", 112, 64), ("mamba2", 80, 128))
#: the tensor-core kernel's chunk and, where it has one, state width, in
#: a mangled name
TC_MANGLED = re.compile(r"ssd_scan_kernel_tcILi(\d+)E(?:Li(\d+)E)?")


def tc_sass(cs, build) -> dict[str, list[str]]:
    """The instructions of each tensor-core instantiation of the
    checkout's K3 library, keyed ``Q<chunk>_N<N>``."""
    out = {}
    for name, body in cs.sass_functions(cs.sass_of(build,
                                                   "ssd_scan")).items():
        if m := TC_MANGLED.search(name):
            out[f"Q{m.group(1)}_N{m.group(2) or 64}"] = [i for _, i in body]
    return out


def one_turn(tree: Path) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as k3

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {"tree": str(tree)}
    for name, H, N in SHAPES:
        ins = cs.ssd_inputs(gen, 1, 4096, H, 1, 64, N, torch.bfloat16)

        def fn():
            return k3.ssd_scan_fwd(*ins, chunk=128)
        out[name] = {"variant": k3.route(torch.bfloat16, 64, N, 128),
                     "ms": [cs.time_cuda(fn, 20, 2) for _ in range(3)],
                     "device_ms": cs.device_ms(fn),
                     "host_us": cs.host_us(fn)}
    out["sass"] = tc_sass(cs, build)
    return out


def summary(rows: list[dict]) -> dict:
    out = {"sass": {}}
    first = rows[0]["sass"]
    for r in rows:
        out["sass"][r["tree"]] = {
            k: {"instructions": len(v),
                "differing_from_first": sum(a != b for a, b in
                                            zip(v, first.get(k, [])))
                + abs(len(v) - len(first.get(k, [])))}
            for k, v in r["sass"].items()}
    for tree in dict.fromkeys(r["tree"] for r in rows):
        mine = [r for r in rows if r["tree"] == tree]
        out[tree] = {}
        for name, _, _ in SHAPES:
            got = {"ms": [statistics.median(r[name]["ms"]) for r in mine],
                   "device_ms": [r[name]["device_ms"] for r in mine],
                   "host_us": [r[name]["host_us"] for r in mine]}
            out[tree][name] = {k: {"median": statistics.median(v),
                                   "min": min(v), "max": max(v)}
                               for k, v in got.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--turns", type=int, default=6)
    ap.add_argument("--one", action="store_true",
                    help="run one turn of the single checkout given, in "
                         "this process")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_turn(args.trees[0].resolve())), flush=True)
        return 0
    rows = []
    for turn in range(args.turns):
        order = args.trees if turn % 2 == 0 else args.trees[::-1]
        for tree in order:
            run = subprocess.run([sys.executable, __file__, "--one",
                                  str(tree)], capture_output=True, text=True,
                                 timeout=600)
            if run.returncode != 0:
                print(run.stderr[-2000:], file=sys.stderr)
                return run.returncode
            rows.append(json.loads(run.stdout.strip().splitlines()[-1]))
            print(json.dumps({k: v for k, v in rows[-1].items()
                              if k != "sass"}), flush=True)
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
