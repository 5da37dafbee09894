#!/usr/bin/env python3
"""Which launch record a profiler session of a cluster-B fleet chunk
loses, and after what.

In ``chip_smoke.py``'s whole run the profile of phase ``fleet``'s chunk
(and that of phase ``batch_optins``) records 63 of the chunk's 64
``select_rows`` launches in every session, while the same profile in a
fresh process records all 64.  This script runs, in one process on one
card, ``chip_smoke.py``'s own functions: the kernel build (phase 0),
cluster B and its cold plan (phase 3), the 8-lane cluster-B fleet of
phase ``fleet``; then ``--before`` profiler sessions of one fleet chunk,
the LM phases that precede the fleet in the whole run (K2, K3, the
zamba2-7b parity and prefill), and ``--after`` sessions again.  Each
session is also made in a variant that launches one small kernel and
synchronizes inside the session before the chunk.  For every session it
records the ``select_rows`` records that ``chip_smoke.kernel_rows``
counts, and from the raw trace (``kineto_results``) the kernel records
and the runtime's launch calls by correlation id: which launch calls
have no kernel record, their place among the session's launches, where
K1's first and last launch stand, and every kernel name that no earlier
session recorded.  With ``--phase-fleet`` it then runs phase ``fleet``
itself and records its seconds.  Prints one JSON line and writes it to
``--out``.

    python3 tools/profile_records.py [--out build/profile_records.json]
        [--before 2] [--after 3] [--phase-fleet]

Needs one card; about five minutes on an H100, phase ``fleet`` aside.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _get(ev, *names):
    for name in names:
        fn = getattr(ev, name, None)
        if fn is not None:
            return fn()
    return None


def session(step, bucket, warm: bool, seen: set) -> dict:
    """One profiler session of a chunk of the live bucket (carry put back
    after); ``warm``: one small kernel and a synchronize inside the
    session first."""
    from torch.profiler import ProfilerActivity, profile
    mask = torch.ones(len(bucket), dtype=torch.bool, device="cuda")
    m = cs.FLEET_CHUNK
    with cs.restored(bucket):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if warm:
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()
            step.run(m, mask)
            torch.cuda.synchronize()
    rows = cs.kernel_rows(prof)
    averaged = cs.matching(rows, cs.K1_KERNEL)[1]
    kernels, launches, names = {}, [], {}
    for ev in prof.profiler.kineto_results.events():
        name = _get(ev, "name")
        corr = _get(ev, "correlation_id")
        start = _get(ev, "start_ns", "start_us")
        dev = str(_get(ev, "device_type"))
        if dev.endswith("CUDA"):
            names[name] = names.get(name, 0) + 1
            kernels.setdefault(corr, []).append((start, name))
        elif "LaunchKernel" in (name or ""):
            launches.append((start, corr, name))
    launches.sort()
    k1_kernels = {c: v for c, v in kernels.items()
                  if any(cs.K1_KERNEL in n for _, n in v)}
    # the launch calls the select_rows wrapper made: the ones whose
    # correlation holds a K1 kernel, and those with no kernel at all
    orphans = [(i, corr, name) for i, (_, corr, name) in enumerate(launches)
               if corr not in kernels]
    k1_order = [i for i, (_, corr, _) in enumerate(launches)
                if corr in k1_kernels]
    new_names = sorted(n for n in names if n not in seen)
    seen.update(names)
    return {"warm": warm, "k1_rows": averaged,
            "k1_kernel_records": sum(len(v) for v in k1_kernels.values()),
            "launch_calls": len(launches),
            "launch_calls_without_kernel": orphans[:8],
            "n_launch_calls_without_kernel": len(orphans),
            "k1_first_last_launch_index": (k1_order[:1] + k1_order[-1:]),
            "kernel_names_not_seen_before": new_names[:20],
            "device_records": sum(names.values())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "profile_records.json")
    ap.add_argument("--before", type=int, default=2)
    ap.add_argument("--after", type=int, default=3)
    ap.add_argument("--phase-fleet", action="store_true")
    args = ap.parse_args()
    t0 = time.perf_counter()
    env = cs.phase_env()
    card = env["card"]
    built = cs.build_cluster_b()
    full = cs.phase_full(card, built=built)
    base = built[0]
    fp, _ = cs.new_fleet(dict(enumerate(cs.fleet_states(base.to_plain()))),
                         cs.FLEET_ROW_CAPACITY)
    (_, bucket), = fp._pack.buckets.items()
    step = fp._step_of(bucket)
    seen: set = set()
    out = {"card": card, "before": [], "after": []}
    for _ in range(args.before):
        for warm in (False, True):
            out["before"].append(session(step, bucket, warm, seen))
    t_lm = time.perf_counter()
    cs.phase_k2(card)
    cs.phase_k3(card)
    cs.phase_lm_parity(card)
    cs.phase_prefill(card)
    out["lm_s"] = time.perf_counter() - t_lm
    for _ in range(args.after):
        for warm in (False, True):
            out["after"].append(session(step, bucket, warm, seen))
    if args.phase_fleet:
        t_f = time.perf_counter()
        cs.phase_fleet(card, base, full, env)
        out["phase_fleet_s"] = time.perf_counter() - t_f
    out["profiles"] = cs.PROFILE_LOG
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
