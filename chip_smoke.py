#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/csrc`` into
``build/repro_torch/``, then runs these phases, one JSON line each, and
exits non-zero if any fails:

0. environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions, the kernel build time;
1. kernel K1 (``masked_select``) against its plain PyTorch version on the
   card, bitwise, over shapes, dtypes, densities, a tie-break row and
   all-invalid rows; kernel, plain, library-call and bound times at the
   cluster-B step shape;
2. bit-identity on the card: ``equilibrium_batch`` on CUDA against the
   port's host ``equilibrium_faithful`` on four small paper clusters,
   source bounds on and off, chunk 1 and 64, plus a row-capacity
   boundary case that forces a re-pad;
3. full size: a cold plan of the paper's cluster B (995 OSDs, 8,731 PGs,
   58,961 shards) to convergence on the card, held to the committed
   ``BENCH_planner.json`` row ``planner.tail.B1x.batch`` (moves, the
   sources-tried histogram, bound hits, pruned sources), one host sync
   per chunk, K1 launched at least once per move; the first 200 moves
   held to the port's host faithful planner; a profiled first chunk;
4. no hidden host sync: one chunk of cluster A under
   ``torch.cuda.set_sync_debug_mode("error")``;
5. the kernel table line; the last line names the device.

``--plan-only`` runs phases 0 and 3 alone and prints no result line: the
way to time two trees in turns within one session on one card.

It imports only ``repro_torch``, torch, NumPy and the standard library.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM memory rate and float32 rate outside the tensor cores
#: (NVIDIA data sheet, 700 W), for the bytes and operations bounds
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
#: the committed reference record of cluster B's full convergence
BENCH_ROW = "planner.tail.B1x.batch"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_cuda(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call from CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 0


def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    print(card, flush=True)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    build_s = time.perf_counter() - t0
    for name, log in reports.items():
        print(f"[ptxas {name}]\n{log.strip()}", file=sys.stderr)
    env = {"card": card, "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "kernels_built": sorted(reports), "build_s": build_s}
    emit("env", **env)
    return env


# ---------------------------------------------------------------------------
# phase 1


def phase_k1() -> dict:
    from repro_torch.kernels.ref import masked_select_ref
    from repro_torch.kernels.select_move import masked_select_fwd
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = []
    for dtype in (np.float64, np.float32):
        for M, D, dens in ((4600, 995, 0.05), (4000, 7960, 0.05),
                           (4600, 995, 0.001), (4600, 995, 0.5),
                           (200, 995, 0.05), (1, 1, 0.0), (3, 7, 0.0)):
            cases.append((f"{M}x{D}@{dens}/{np.dtype(dtype).name}",
                          rng.random((M, D)) < dens,
                          rng.random(D).astype(dtype)))
        # ties: equal utilization on legal destinations → lowest index
        util = rng.random(995).astype(dtype)
        util[[10, 500, 900]] = util.min() / 2
        valid = rng.random((64, 995)) < 0.5
        valid[:, [10, 500, 900]] = True
        valid[1, 10] = False
        cases.append((f"ties/{np.dtype(dtype).name}", valid, util))
        cases.append((f"tie-row/{np.dtype(dtype).name}",
                      np.array([[True, True, True, False]]),
                      np.array([0.5, 0.2, 0.2, 0.0], dtype)))
    worst = 0
    for name, valid, util in cases:
        v = torch.as_tensor(valid, device=dev)
        u = torch.as_tensor(util, device=dev)
        any_k, dst_k = masked_select_fwd(v, u)
        any_p, dst_p = masked_select_ref(v, u)
        torch.cuda.synchronize()
        err = int((dst_k.long() - dst_p.long()).abs().max())
        worst = max(worst, err)
        check(torch.equal(any_k, any_p) and torch.equal(dst_k, dst_p),
              f"K1 differs from its plain version on case {name} "
              f"(max |dst diff| {err})")
    tie_any, tie_dst = masked_select_fwd(
        torch.tensor([[True, True, True, False]], device=dev),
        torch.tensor([0.5, 0.2, 0.2, 0.0], dtype=torch.float64, device=dev))
    check(bool(tie_any[0]) and int(tie_dst[0]) == 1, "K1 tie-break")

    # times at the cluster-B step shape: 25 sources x 184 rows, 995 OSDs
    M, D = 25 * 184, 995
    v = torch.as_tensor(rng.random((M, D)) < 0.05, device=dev)
    u = torch.as_tensor(rng.random(D), dtype=torch.float64, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    k_ms = time_cuda(lambda: masked_select_fwd(v, u))
    p_ms = time_cuda(lambda: masked_select_ref(v, u))
    lib_ms = time_cuda(lambda: torch.where(v, u, inf).min(dim=1))
    # least work: read the mask and util once, write any and dst once;
    # one comparison per mask entry
    nbytes = M * D + D * 8 + M * (1 + 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = M * D / VECTOR_OPS_PER_S * 1e3
    out = {"cases": len(cases), "max_abs_err": worst, "shape": [M, D],
           "dtype": "float64", "ms": k_ms, "plain_ms": p_ms,
           "library_ms": lib_ms, "bytes": nbytes, "ops": M * D,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    emit("k1", **out)
    return out


# ---------------------------------------------------------------------------
# phase 2


def as_tuples(moves):
    return [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in moves]


def same_plan(ref, got) -> bool:
    return (as_tuples(ref.moves) == as_tuples(got.moves)
            and [r.variance_after for r in ref.records]
            == [r.variance_after for r in got.records]
            and [r.sources_tried for r in ref.records]
            == [r.sources_tried for r in got.records])


def phase_small() -> dict:
    from repro_torch import obs
    from repro_torch.core import clustergen
    from repro_torch.core.dense import DenseState
    from repro_torch.core.equilibrium import EquilibriumConfig
    from repro_torch.core.planner import create_planner
    runs = 0
    t0 = time.perf_counter()
    for name, max_moves in (("small_test_cluster", None), ("cluster_a", None),
                            ("cluster_c", 200), ("cluster_f", 200)):
        cfg = EquilibriumConfig() if max_moves is None \
            else EquilibriumConfig(max_moves=max_moves)
        base = getattr(clustergen, name)()
        ref = create_planner("equilibrium_faithful", cfg=cfg).plan(
            base.copy(), record_trajectory=True)
        ref_b = create_planner("equilibrium_faithful", cfg=cfg,
                               source_bounds=True).plan(base.copy())
        for bounds in (True, False):
            for chunk in (1, 64):
                got = create_planner("equilibrium_batch", cfg=cfg,
                                     chunk=chunk, source_bounds=bounds,
                                     device="cuda").plan(
                    base.copy(), record_trajectory=True)
                runs += 1
                check(same_plan(ref, got),
                      f"{name} bounds={bounds} chunk={chunk}: batch on the "
                      f"card differs from the faithful planner")
                if bounds:
                    check(got.stats["bound_hits"] == ref_b.stats["bound_hits"]
                          and got.stats["pruned_sources"]
                          == ref_b.stats["pruned_sources"],
                          f"{name} chunk={chunk}: certificate counters")
    # row capacity at the exact per-device maximum (rounded up to 8
    # rows, less than a chunk of slack): forces a re-pad
    base = clustergen.small_test_cluster()
    mx = max(len(s) for s in DenseState(base).rows_on_dev)
    ref = create_planner("equilibrium_faithful").plan(
        base.copy(), record_trajectory=True)
    snap = obs.registry().snapshot()
    got = create_planner("equilibrium_batch", row_capacity=mx, chunk=8,
                         device="cuda").plan(base.copy(),
                                             record_trajectory=True)
    repads = int(obs.registry().deltas_since(snap).get("batch.repads", 0))
    runs += 1
    check(same_plan(ref, got), "row-capacity boundary run differs")
    check(repads >= 1, "row-capacity boundary run did not re-pad")
    out = {"runs": runs, "identical": True, "repads": repads,
           "repad_run_syncs": got.stats["host_syncs"],
           "seconds": time.perf_counter() - t0}
    emit("small_clusters", **out)
    return out


# ---------------------------------------------------------------------------
# phase 3


def bench_row() -> dict:
    rows = json.loads((ROOT / "BENCH_planner.json").read_text())
    row = next(r for r in rows if r["name"] == BENCH_ROW)
    fields = dict(kv.split("=", 1) for kv in row["derived"].split(";"))
    hist = {int(k): int(v) for k, v in
            (kv.split(":") for kv in fields["tried_hist"].split(","))}
    return {"converged": int(fields["converged"]), "tried_hist": hist,
            "bound_hits": int(fields["bound_hits"]),
            "pruned_sources": int(fields["pruned_sources"])}


def profile_chunk(state, card: str) -> dict:
    """Kernel time by name over the first chunk of a fresh cluster-B plan
    (profiler on; its timings are read for shares, not reported as the
    plan's speed)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.equilibrium_batch import BatchPlanner
    planner = BatchPlanner(state, device="cuda")
    planner.sync()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = planner._step.run(planner.chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    moves = int((out[:5 * planner.chunk].view(-1, 5)[:, 0] >= 0).sum())
    rows = []
    for ev in prof.key_averages():
        if str(ev.device_type) != "DeviceType.CUDA":
            continue                    # host-side rows; kernels below
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    ops = sum(r[2] for r in rows)
    return {"card": card, "chunk_steps": planner.chunk, "moves": moves,
            "wall_s": wall, "device_busy_s": busy_s if rows else None,
            "idle_share": (1.0 - busy_s / wall) if rows else None,
            "device_ops": ops, "device_ops_per_step": ops / planner.chunk,
            "top": [{"name": k[:80], "device_ms": us / 1e3, "calls": n}
                    for us, k, n in rows[:12]]}


def phase_full(card: str) -> dict:
    from repro_torch import obs
    from repro_torch.core.clustergen import cluster_b
    from repro_torch.core.planner import create_planner
    from repro_torch.kernels import select_move
    want = bench_row()
    t0 = time.perf_counter()
    base = cluster_b(scale=1)
    build_s = time.perf_counter() - t0
    check((base.n_devices, len(base.acting)) == (995, 8731),
          "cluster B shape")

    planner = create_planner("equilibrium_batch", device="cuda")
    state = base.copy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reg = obs.registry()
    snap = reg.snapshot()
    select_move.reset_launch_count()          # the main path's run only
    t0 = time.perf_counter()
    res = planner.plan(state, record_trajectory=True,
                       record_free_space=False)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    launches = select_move.launch_count()
    chunk_s = res.stats["selection_seconds"]    # every chunk's wall time
    peak = torch.cuda.max_memory_allocated()
    d = reg.deltas_since(snap)
    chunks = int(d.get("batch.chunks", 0))
    repads = int(d.get("batch.repads", 0))
    st = res.stats
    n = len(res.moves)
    hist = {int(k): v for k, v in st["sources_tried_hist"].items()}
    check(n == want["converged"], f"cluster B converged in {n} moves, "
          f"expected {want['converged']}")
    check(hist == want["tried_hist"], "cluster B sources_tried histogram")
    check(st["bound_hits"] == want["bound_hits"],
          f"bound_hits {st['bound_hits']} != {want['bound_hits']}")
    check(st["pruned_sources"] == want["pruned_sources"],
          f"pruned_sources {st['pruned_sources']} != "
          f"{want['pruned_sources']}")
    check(st["host_syncs"] == chunks + repads,
          f"host syncs {st['host_syncs']} != chunks {chunks} + re-pads "
          f"{repads}")
    check(launches >= n, f"K1 launched {launches} times for {n} moves")

    # the first 200 moves, bitwise against the host faithful planner
    t1 = time.perf_counter()
    ref = create_planner("equilibrium_faithful").plan(
        base.copy(), budget=200, record_trajectory=True,
        record_free_space=False)
    faithful_s = time.perf_counter() - t1
    check(as_tuples(ref.moves) == as_tuples(res.moves[:200])
          and [r.variance_after for r in ref.records]
          == [r.variance_after for r in res.records[:200]]
          and [r.sources_tried for r in ref.records]
          == [r.sources_tried for r in res.records[:200]],
          "cluster B: first 200 moves differ from the faithful planner")

    out = {"card": card, "cluster_build_s": build_s, "moves": n,
           "plan_s": plan_s, "moves_per_s": n / plan_s,
           "chunks_s": chunk_s, "setup_s": plan_s - chunk_s,
           "host_syncs": st["host_syncs"], "chunks": chunks,
           "repads": repads, "k1_launches": launches,
           "bound_hits": st["bound_hits"],
           "pruned_sources": st["pruned_sources"],
           "peak_mem_bytes": peak, "faithful_200_s": faithful_s,
           "variance_before": base.utilization_variance(),
           "variance_after": state.utilization_variance()}
    emit("cluster_b", **out)
    prof = profile_chunk(base.copy(), card)
    emit("cluster_b_profile", **prof)
    out["profile"] = prof
    return out


# ---------------------------------------------------------------------------
# phase 4


def phase_no_sync() -> dict:
    from repro_torch.core.clustergen import cluster_a
    from repro_torch.core.equilibrium_batch import BatchPlanner
    planner = BatchPlanner(cluster_a(), device="cuda")
    planner.sync()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = planner._step.run(planner.chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    moves = int((out[:5 * planner.chunk].view(-1, 5)[:, 0] >= 0).sum())
    check(moves > 0, "cluster A chunk emitted no move")
    res = {"chunk": planner.chunk, "moves": moves, "syncs_in_chunk": 0}
    emit("no_sync", **res)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plan-only", action="store_true",
                    help="build the kernels and run only the cluster-B "
                         "phase (for timing two trees in one session); "
                         "prints no result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir() \
            or not (ROOT / "BENCH_planner.json").is_file():
        print(f"chip_smoke: the repository is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    env = phase_env()
    if args.plan_only:
        phase_full(env["card"])
        return 0
    k1 = phase_k1()
    phase_small()
    full = phase_full(env["card"])
    phase_no_sync()
    print(json.dumps({"kernels": [{
        "name": "masked_select", "route": "cuda",
        "source": "src/repro_torch/csrc/masked_select.cu",
        "replaces": "src/repro/kernels/select_move.py:44",
        "launches": full["k1_launches"], "matches_plain": True,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
