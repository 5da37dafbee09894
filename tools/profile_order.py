#!/usr/bin/env python3
"""Whether what runs before it makes the profile of the mamba2-2.7b
prefill (phase 10 of ``chip_smoke.py``) lose launch records.

Runs, in one process on one card, ``chip_smoke.py``'s own phase
functions: first the kernel builds, phase K1, ``cluster_b_lifecycle``
and ``fuzz`` (``batch_optins`` reads the results of K1 and ``fuzz``),
then the steps of ``--sequence`` in order, and records, for each run of
phase 10, how many profiler sessions it took and what each lost session
missed.  The steps:

- ``lm``: the phases that precede phase 10 in the script (K2, K3, the
  zamba2-7b parity and prefill, the mamba2-2.7b parity);
- ``optins``: phase ``batch_optins``;
- ``release``: a garbage collection and the allocator's cache emptied;
- ``phase10``: phase 10.

The default sequence is phase 10 twice after ``lm``, then twice right
after ``optins``, then after ``optins`` followed by ``lm`` (the order in
which ``batch_optins`` once ran before the prefills).

With ``--records``, it asks instead whether the loss follows the
number of device records that earlier profiler sessions of the process
took: it runs phase 10, then a session of ``--filler`` one-element adds
(its kernel records counted), then phase 10 again, and so on until a run
of phase 10 has lost a record twice or ``--rounds`` have passed; each run
gives the device records of every session before it.

A run of phase 10 that loses a record in all its sessions is recorded,
not raised, so every run is made.  Prints one JSON line and writes it to
``--out``.

    python3 tools/profile_order.py [--out chiprun_out/profile_order.json]
        [--sequence lm,phase10,...]
        [--records [--filler 16384] [--rounds 10]]

Needs one card; about 25 minutes on an H100 for the default sequence,
3 for ``--records``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

DEFAULT_SEQUENCE = ("lm,phase10,phase10,optins,phase10,optins,phase10,"
                    "optins,lm,phase10")

#: device records of every profiler session of this process so far
RECORDS = [0]


def _counting_rows(prof):
    rows = _kernel_rows(prof)
    RECORDS[0] += sum(c for _, c in rows.values())
    return rows


_kernel_rows, cs.kernel_rows = cs.kernel_rows, _counting_rows


def phase10(card: str, after: str) -> dict:
    """One run of phase 10; its sessions and lost-record messages."""
    err = io.StringIO()
    t0 = time.perf_counter()
    n_log = len(cs.PROFILE_LOG)
    before = RECORDS[0]
    ok = True
    with contextlib.redirect_stderr(err):
        try:
            cs.phase_prefill(card, "mamba2-2.7b", 0,
                             {"tensor_core": 64, "simt": 0},
                             "mamba2_prefill")
        except SystemExit as e:
            ok = False
            failure = str(e)
    lost = [ln for ln in err.getvalue().splitlines()
            if "lost launch records" in ln]
    new = cs.PROFILE_LOG[n_log:]
    out = {"after": after, "passed": ok, "records_before": before,
           "sessions": new[-1]["sessions"] if new else None,
           "sessions_lost": len(lost), "lost": lost,
           "seconds": time.perf_counter() - t0}
    if not ok:
        out["failure"] = failure
    print(json.dumps({"phase10_run": out}), flush=True)
    return out


def filler_session(n: int) -> int:
    """One profiler session of ``n`` one-element adds; its device
    records."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()
    return sum(c for _, c in _counting_rows(prof).values())


def by_records(card: str, filler: int, rounds: int) -> list[dict]:
    runs, lost = [], 0
    for _ in range(rounds):
        run = phase10(card, f"{RECORDS[0]} device records profiled")
        runs.append(run)
        lost += run["sessions_lost"] > 0
        if lost >= 2:
            break
        run["filler_records"] = filler_session(filler)
    return runs


def by_sequence(card: str, env: dict, steps: list[str]) -> list[dict]:
    base = cs.build_cluster_b()[0]
    k1 = cs.phase_k1(card, base, env)
    life = cs.phase_lifecycle(card, base)
    cs.phase_fuzz(card, base, life)

    def lm():
        cs.phase_k2(card)
        cs.phase_k3(card)
        cs.phase_lm_parity(card)
        cs.phase_prefill(card)
        cs.phase_lm_parity(card, "mamba2-2.7b", 4, (0, 4), "mamba2_parity")

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    act = {"lm": lm, "optins": lambda: cs.phase_batch_optins(card, base, k1),
           "release": release}
    runs, since = [], []
    for step in steps:
        if step == "phase10":
            runs.append(phase10(card, ", ".join(since) or "the start"))
            since = []
        else:
            act[step]()
            since.append(step)
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "profile_order.json"))
    ap.add_argument("--sequence", default=DEFAULT_SEQUENCE)
    ap.add_argument("--records", action="store_true")
    ap.add_argument("--filler", type=int, default=16384)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    steps = args.sequence.split(",")
    unknown = set(steps) - {"lm", "optins", "release", "phase10"}
    if unknown:
        ap.error(f"unknown steps {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("profile_order: no CUDA device", file=sys.stderr)
        return 2
    env = cs.phase_env()
    card = env["card"]
    if args.records:
        out = {"card": card, "filler": args.filler,
               "runs": by_records(card, args.filler, args.rounds)}
    else:
        out = {"card": card, "sequence": steps,
               "runs": by_sequence(card, env, steps)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
