#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Builds every CUDA kernel of the port (K1, K2, K3) from
``src/repro_torch/csrc`` into ``build/repro_torch/``, then runs these
phases, one JSON line each, and exits non-zero if any fails:

0. environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions, the kernel build time; ``cuobjdump -sass`` of
   K2's and of K3's library must show ``HGMMA`` (the tensor-core kernels
   are on the tensor cores), and the registers, stack and spills of each
   tensor-core kernel from the ``-Xptxas -v`` report (K3's with no
   spills);
1. kernel K1 (``masked_select``) against its plain PyTorch version on the
   card, bitwise, over shapes, dtypes, densities, a tie-break row and
   all-invalid rows; kernel, plain, library-call and bound times at the
   cluster-B step shape, on CUDA events and on the device's clock;
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
   then the same for ``cluster_b(scale=2)`` against
   ``planner.tail.B2x.batch`` (1,385 moves);
4. no hidden host sync: one chunk of cluster A under
   ``torch.cuda.set_sync_debug_mode("error")``;
5. kernel K2 (``flash_attention``) against its plain version over the
   reference sweep (T and Dh grid, f32 and bf16, GQA, window / softcap /
   causal variants), Dh 112 and 256, windows that skip whole key tiles,
   and the zamba2-7b shape; then bf16 cases of the tensor-core variant
   (Dh 16 to 128, GQA, window and softcap, non-causal, ragged T, skipped
   tiles) against the float32 plain version of the same bf16 inputs; at
   the zamba2-7b shape K2's max abs error and worst row error against
   that float32 version within twice SDPA's; misaligned bf16 views
   raise; launches by variant; kernel, plain, SDPA and bound times;
6. kernel K3 (``ssd_scan``) against its plain version over the reference
   sweep (G < H included), strided xBC views and the zamba2-7b shape;
   then bf16 cases of the tensor-core variant (chunk 64 and 128, G > 1
   over 4 and more chunks, the model's dt and A ramps, strided xBC
   views) against the float32 plain version of the same bf16 inputs; at
   the zamba2-7b shape with the ramps, its max abs and worst row error
   within 4 x the SIMT variant's on the same inputs (at chunk 32);
   misaligned bf16 views raise; launches by variant; kernel, plain and
   bound times;
7. zamba2-7b at full width, 6 layers, float32: prefill on the card
   (through K2 and K3, launched 1 and 6 times) against the same
   parameters on the CPU (plain versions), rtol = atol = 1e-3; K2 and
   K3 on their SIMT variants;
8. zamba2-7b at full width and depth, bf16, B 1, T 4096 (the registry's
   ``prefill_32k`` cut from B 32, S 32768): finite logits, K2 launched
   14 times and K3 81 times, all on their tensor-core variants, seconds,
   tokens/s, peak memory and the profiled device-time shares of K2, K3
   (all of it the tensor-core kernel) and the rest;
9. the kernel table line; the last line names the device.

``--plan-only`` runs phases 0 and 3 (scale 1) alone and prints no result
line: the way to time two trees in turns within one run on one card.

It imports only ``repro_torch``, torch, NumPy and the standard library.
"""

from __future__ import annotations

import argparse
import json
import re
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
#: the committed reference records of cluster B's full convergence, by
#: scale
BENCH_ROWS = {1: "planner.tail.B1x.batch", 2: "planner.tail.B2x.batch"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_cuda(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call from CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls.  A call shorter than the
    host's time to issue it reads the issue rate: :func:`device_ms`
    gives the device's own time."""
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


def kernel_ms(prof, per_launch: bool = False) -> dict[str, float]:
    """Device milliseconds by kernel name in a profile: the total, or
    with ``per_launch`` the mean over the kernel's recorded launches."""
    by_name: dict[str, float] = {}
    counts: dict[str, int] = {}
    for ev in prof.key_averages():
        if str(ev.device_type) != "DeviceType.CUDA":
            continue                    # host-side rows; kernels below
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
        counts[ev.key] = counts.get(ev.key, 0) + ev.count
    if per_launch:
        return {k: v / max(counts[k], 1) for k, v in by_name.items()}
    return by_name


def device_ms(fn, iters: int = 20, warmup: int = 3
              ) -> tuple[float, dict[str, float]]:
    """Device milliseconds per call on the device's clock: the profiler's
    mean device time per launch of each kernel that ``fn`` launches
    (once per call each), summed, so that the host's issue rate cannot
    set it; and the same by kernel name.  Means over the recorded
    launches: over ``iters`` back-to-back calls the profiler may keep
    fewer than ``iters`` launches of a kernel (PERF.md §6)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = kernel_ms(prof, per_launch=True)
    check(sum(by_name.values()) > 0, "the profiler saw no device time")
    return sum(by_name.values()), by_name


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
           "kernels_built": sorted(reports), "build_s": build_s,
           **k2_instructions(build), **k3_instructions(build)}
    emit("env", **env)
    return env


def ptxas_kernels(log: str) -> dict:
    """Registers, stack and spill bytes of each entry function in an
    ``-Xptxas -v`` report, by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) "
                                      r"bytes spill stores, (\d+) bytes "
                                      r"spill loads", line)):
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


def sass_hgmma(build, name: str, kernel: str) -> int:
    """HGMMA (wgmma) instructions in ``cuobjdump -sass`` of
    ``csrc/<name>.cu``'s library; fails at none."""
    lib = build.library_path(name)
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump -sass {lib.name} failed: "
                                f"{sass.stderr.strip()[-400:]}")
    hgmma = len(re.findall(r"\bHGMMA\b", sass.stdout))
    check(hgmma > 0, f"{kernel}'s library has no HGMMA instruction: the "
                     f"tensor-core kernel does not run on the tensor cores")
    return hgmma


def k2_instructions(build) -> dict:
    """K2's library on the tensor cores: ``cuobjdump -sass`` must show
    HGMMA (wgmma); the registers and spills of each tensor-core
    instantiation (by Dh) and any wgmma serialisation ptxas reported."""
    hgmma = sass_hgmma(build, "flash_attention", "K2")
    log = build.ptxas_report("flash_attention")
    tc = {f"Dh{16 * int(m.group(1))}": stats
          for name, stats in ptxas_kernels(log).items()
          if (m := re.search(r"flash_fwd_kernel_tcILi(\d+)E", name))}
    check(len(tc) == 8, f"the ptxas report lists {len(tc)} tensor-core "
                        f"instantiations of K2, expected 8")
    return {"k2_sass_hgmma": hgmma,
            "k2_tensor_core_ptxas": dict(sorted(
                tc.items(), key=lambda kv: int(kv[0][2:]))),
            "k2_wgmma_serialized": [line.strip() for line in
                                    log.splitlines()
                                    if "serializ" in line]}


def k3_instructions(build) -> dict:
    """K3's library on the tensor cores: ``cuobjdump -sass`` must show
    HGMMA; the registers, stack and spills of each tensor-core
    instantiation (by chunk), none of which may spill."""
    hgmma = sass_hgmma(build, "ssd_scan", "K3")
    log = build.ptxas_report("ssd_scan")
    tc = {f"Q{m.group(1)}": stats
          for name, stats in ptxas_kernels(log).items()
          if (m := re.search(r"ssd_scan_kernel_tcILi(\d+)E", name))}
    check(len(tc) == 2, f"the ptxas report lists {len(tc)} tensor-core "
                        f"instantiations of K3, expected 2")
    spilled = {k: v for k, v in tc.items()
               if v.get("spill_stores") or v.get("spill_loads")}
    check(not spilled, f"K3's tensor-core kernels spill: {spilled}")
    return {"k3_sass_hgmma": hgmma,
            "k3_tensor_core_ptxas": dict(sorted(tc.items())),
            "k3_wgmma_serialized": [line.strip() for line in
                                    log.splitlines()
                                    if "serializ" in line]}


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
    k_dev, _ = device_ms(lambda: masked_select_fwd(v, u), 50)
    lib_dev, _ = device_ms(lambda: torch.where(v, u, inf).min(dim=1), 50)
    # least work: read the mask and util once, write any and dst once;
    # one comparison per mask entry
    nbytes = M * D + D * 8 + M * (1 + 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = M * D / VECTOR_OPS_PER_S * 1e3
    out = {"cases": len(cases), "max_abs_err": worst, "shape": [M, D],
           "dtype": "float64", "ms": k_ms, "plain_ms": p_ms,
           "library_ms": lib_ms, "device_ms": k_dev,
           "library_device_ms": lib_dev, "bytes": nbytes, "ops": M * D,
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


def bench_row(name: str) -> dict:
    rows = json.loads((ROOT / "BENCH_planner.json").read_text())
    row = next(r for r in rows if r["name"] == name)
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


def phase_full(card: str, scale: int = 1) -> dict:
    from repro_torch import obs
    from repro_torch.core.clustergen import cluster_b
    from repro_torch.core.planner import create_planner
    from repro_torch.kernels import select_move
    want = bench_row(BENCH_ROWS[scale])
    t0 = time.perf_counter()
    base = cluster_b(scale=scale)
    build_s = time.perf_counter() - t0
    check((base.n_devices, len(base.acting)) == (995 * scale, 8731 * scale),
          f"cluster B x{scale} shape")

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
    check(n == want["converged"], f"cluster B x{scale} converged in {n} "
          f"moves, expected {want['converged']}")
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

    out = {"card": card, "scale": scale, "cluster_build_s": build_s,
           "moves": n,
           "plan_s": plan_s, "moves_per_s": n / plan_s,
           "chunks_s": chunk_s, "setup_s": plan_s - chunk_s,
           "host_syncs": st["host_syncs"], "chunks": chunks,
           "repads": repads, "k1_launches": launches,
           "bound_hits": st["bound_hits"],
           "pruned_sources": st["pruned_sources"],
           "peak_mem_bytes": peak, "faithful_200_s": faithful_s,
           "variance_before": base.utilization_variance(),
           "variance_after": state.utilization_variance()}
    if scale != 1:
        emit(f"cluster_b{scale}", **out)
        return out
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


# ---------------------------------------------------------------------------
# phases 5-8: the LM prefill trunk (kernels K2 and K3, zamba2-7b)

#: H100 SXM dense rates (NVIDIA data sheet, 700 W) by input type: the
#: bf16 tensor-core rate, and float32 outside the tensor cores
OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: VECTOR_OPS_PER_S}
#: K2 and K3 against their plain versions: |kernel - plain| must be at
#: most tol + tol * |plain| (rtol = atol = tol), by dtype
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: zamba2-7b prefill at full width and depth: the registry's prefill_32k
#: (B 32, S 32768) cut for the run's time limit and the simple kernels
PREFILL_B, PREFILL_T = 1, 4096
#: K2 and K3 kernel names as the profiler lists them
K2_KERNEL, K3_KERNEL = "flash_fwd_kernel", "ssd_scan_kernel"


#: the largest relative L2 error of one K2 or K3 output row (over Dh or
#: P) that a bf16 call may have against the float32 plain version of its
#: inputs: bf16 rounds the output (and K2's P) to 2^-9, a fifth of it; a
#: key tile dropped from a row of up to 4,096 keys costs at least
#: sqrt(128 / 4096) = 0.18; K3's float32 operands as one bf16 term each
#: (not two) reach 0.026 (PERF.md §6)
ROW_REL_TOL = 1e-2


def compare(got: torch.Tensor, want: torch.Tensor,
            dtype: torch.dtype | None = None) -> tuple[float, float]:
    """(max |got - want|, the largest share of the tolerance of
    ``dtype`` (default want's) that any element uses: the check passes
    at ≤ 1)."""
    tol = KERNEL_TOL[dtype or want.dtype]
    err = (got.float() - want.float()).abs()
    return float(err.max()), float((err / (tol + tol * want.float().abs()))
                                   .max())


def attention_errors(got: torch.Tensor, want: torch.Tensor
                     ) -> tuple[float, float]:
    """(max abs error, worst relative L2 error of an output row over Dh)
    of attention outputs against a float32 ``want``."""
    d = got.float() - want
    row = d.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-6)
    return float(d.abs().max()), float(row.max())


def bound(nbytes: float, ops: float, dtype: torch.dtype) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS_PER_S[dtype] * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_k2(card: str) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_plain
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16

    def qkv(B, T, H, KV, Dh, dtype):
        return tuple(torch.randn((B, T, h, Dh), generator=gen,
                                 device=dev).to(dtype) for h in (H, KV, KV))

    # (name, (B, T, H, KV, Dh, dtype), options): the sweep of
    # tests/test_kernels.py:20-84 (T and Dh grid, f32 and bf16, GQA
    # through ops, the mask variants, the model's attention shape), then
    # Dh 112 and 256, windows that skip whole key tiles, and the zamba2-7b
    # prefill shape in float32 (where the limit is far below the output's
    # scale) and in bfloat16
    cases = [(f"T{T} Dh{Dh} {str(dt)[6:]}", (2, T, 4, 2, Dh, dt), {})
             for T, Dh, dt in ((128, 64, f32), (256, 64, f32),
                               (128, 128, f32), (96, 64, f32),
                               (128, 64, bf16), (128, 112, f32),
                               (256, 112, bf16), (128, 256, f32),
                               (200, 256, bf16))]
    cases += [(f"mask w{w} cap{c} causal{z}", (1, 128, 2, 2, 64, f32),
               dict(window=w, cap=c, causal=z))
              for w, c, z in ((None, None, True), (32, None, True),
                              (None, 50.0, True), (48, 30.0, True),
                              (None, None, False))]
    cases += [("model H8 KV4 w64", (2, 128, 8, 4, 64, f32), dict(window=64)),
              ("skip tiles w100", (1, 1024, 4, 4, 112, f32),
               dict(window=100)),
              ("skip tiles w100 non-causal", (1, 1024, 4, 4, 64, bf16),
               dict(window=100, causal=False)),
              *((f"zamba2 B{PREFILL_B} T{PREFILL_T} H32 Dh112 "
                 f"{str(dt)[6:]}", (PREFILL_B, PREFILL_T, 32, 32, 112, dt),
                 {}) for dt in (f32, bf16))]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    zamba2_err = {}                           # max abs err at its shape
    tol_use = 0.0
    k2.reset_launch_count()
    for name, shape, kw in cases:
        q, k, v = qkv(*shape)
        got = ops.flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err, use = compare(got, want)
        key = str(shape[-1])[6:]
        worst[key] = max(worst[key], err)
        if name.startswith("zamba2"):
            zamba2_err[key] = err
        tol_use = max(tol_use, use)
        check(use <= 1, f"K2 differs from its plain version on {name} "
                        f"(max abs err {err})")
        del q, k, v, got, want
        torch.cuda.empty_cache()
    sweep_launches = k2.launch_counts()

    # the tensor-core variant: bf16 cases against the float32 plain
    # version of the same bf16 inputs
    tc_cases = [(f"tc Dh{Dh} T{T}", (2, T, 4, 4, Dh, bf16), {})
                for T, Dh in ((256, 64), (256, 112), (256, 128))]
    tc_cases += [(f"tc GQA Dh{Dh} ragged T200", (2, 200, 8, 2, Dh, bf16),
                  {}) for Dh in range(16, 129, 16)]
    tc_cases += [("tc GQA H8 KV2", (2, 256, 8, 2, 112, bf16), {}),
                 ("tc w48 cap30", (1, 384, 4, 4, 112, bf16),
                  dict(window=48, cap=30.0)),
                 ("tc non-causal", (2, 256, 4, 4, 64, bf16),
                  dict(causal=False)),
                 ("tc skip tiles w100", (1, 1024, 4, 4, 112, bf16),
                  dict(window=100)),
                 ("tc skip tiles w100 non-causal", (1, 1024, 4, 2, 128, bf16),
                  dict(window=100, causal=False))]
    tc_abs = tc_row = tc_use = 0.0
    k2.reset_launch_count()
    for name, shape, kw in tc_cases:
        q, k, v = qkv(*shape)
        got = ops.flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        abs_err, row_err = attention_errors(got, want)
        _, use = compare(got, want, bf16)
        tc_abs, tc_row = max(tc_abs, abs_err), max(tc_row, row_err)
        tc_use = max(tc_use, use)
        check(use <= 1 and row_err <= ROW_REL_TOL,
              f"K2 tensor-core variant differs from the float32 plain "
              f"version on {name} (max abs err {abs_err}, worst row "
              f"error {row_err})")
    tc_launches = k2.launch_counts()
    check(tc_launches == {"tensor_core": len(tc_cases), "simt": 0},
          f"the bf16 cases launched {tc_launches}, expected all "
          f"{len(tc_cases)} on the tensor-core variant")

    # a bf16 call that TMA cannot read raises and launches nothing
    buf = torch.randn(2 * 64 * 4 * 64 + 1, device=dev).to(bf16)
    wide = torch.randn((2, 64, 4, 68), device=dev).to(bf16)
    misaligned = {"pointer one element off": buf[1:].view(2, 64, 4, 64),
                  "136-byte head stride": wide[..., :64]}
    k2.reset_launch_count()
    raised = []
    for name, bad in misaligned.items():
        try:
            k2.flash_attention_fwd(bad, bad, bad)
        except ValueError:
            raised.append(name)
    check(raised == list(misaligned) and k2.launch_count() == 0,
          f"misaligned bf16 views: raised on {raised} of "
          f"{list(misaligned)}, {k2.launch_count()} launches")

    # the zamba2-7b shape: accuracy gate, then times
    B, T, H, Dh = PREFILL_B, PREFILL_T, 32, 112
    q, k, v = qkv(B, T, H, H, Dh, bf16)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    want = flash_attention_plain(q.float(), k.float(), v.float())
    k2.reset_launch_count()
    k2_abs, k2_row = attention_errors(k2.flash_attention_fwd(q, k, v), want)
    check(k2.launch_counts()["tensor_core"] == 1,
          "K2 at the zamba2 shape did not take the tensor-core variant")
    lib_abs, lib_row = attention_errors(F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True).transpose(1, 2), want)
    del want
    torch.cuda.empty_cache()
    gate = {"k2_max_abs_err": k2_abs, "sdpa_max_abs_err": lib_abs,
            "k2_worst_row_rel_err": k2_row, "sdpa_worst_row_rel_err": lib_row,
            "reference": "flash_attention_plain on float32 copies of the "
                         "bf16 inputs", "limit": "K2 <= 2 x SDPA, each"}
    check(k2_abs <= 2 * lib_abs and k2_row <= 2 * lib_row,
          f"K2 at the zamba2 shape is less accurate than twice SDPA: {gate}")

    ms = time_cuda(lambda: k2.flash_attention_fwd(q, k, v), 20, 2)
    plain_ms = time_cuda(lambda: flash_attention_plain(q, k, v), 5, 1)
    lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20, 2)
    dev_ms, _ = device_ms(lambda: k2.flash_attention_fwd(q, k, v))
    lib_dev_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    pairs = T * (T + 1) // 2                  # legal (query, key) pairs
    out = {"card": card, "cases": len(cases) + len(tc_cases),
           "max_abs_err": max(worst.values()),
           "max_abs_err_by_dtype": worst, "tolerance": "rtol = atol = "
           "1e-4 (float32), 2e-2 (bfloat16)", "tolerance_used": tol_use,
           "zamba2_shape_max_abs_err": zamba2_err,
           "tensor_core_vs_float32": {
               "cases": len(tc_cases), "max_abs_err": tc_abs,
               "worst_row_rel_err": tc_row, "tolerance_used": tc_use,
               "row_rel_tol": ROW_REL_TOL},
           "zamba2_gate": gate, "misaligned_raised": raised,
           "launches_by_variant": {"sweep": sweep_launches,
                                   "tensor_core_cases": tc_launches},
           "variant": "tensor_core",
           "shape": {"B": B, "T": T, "H": H, "Dh": Dh, "dtype": "bfloat16",
                     "causal": True},
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
           "library": "torch.nn.functional.scaled_dot_product_attention",
           **bound(4 * B * T * H * Dh * 2, 4 * Dh * pairs * B * H, bf16)}
    emit("k2", **out)
    return out


#: the tensor-core K3's max abs and worst row error against the float32
#: plain version may be at most this many times the SIMT variant's on the
#: same bf16 inputs (zamba2 shape, the model's dt and A ramps;
#: PERF.md §6)
K3_TC_ERR_FACTOR = 4.0
#: K3's tensor-core kernel as the profiler names it (its flags are zeroed
#: by a fill kernel of the wrapper's, outside the name)
K3_TC_KERNEL = "ssd_scan_kernel_tc"


def ssd_inputs(gen, B, T, H, G, P, N, dtype, ramp: bool = False):
    """x, dt, A, B, C for K3.  The reference suite's draws
    (tests/test_kernels.py:141-143: dt = softplus(N(0,1) - 1), A =
    -exp(0.3 N(0,1))) decay the carried state to about e^-50 per chunk of
    128; ``ramp`` takes the model's instead (models/lm.py::_init_leaf:
    dt_bias from softplus^-1 of 1e-3 .. 1e-1 over the heads plus N(0,
    0.5^2) per token, A = -(1 .. 16)), where the state carries."""
    dev = gen.device
    x = torch.randn((B, T, H, P), generator=gen, device=dev).to(dtype)
    if ramp:
        from repro_torch.models.lm import ssd_ramps
        dt_h, A = ssd_ramps(H, device=dev)
        dt = torch.nn.functional.softplus(
            torch.log(torch.expm1(dt_h))
            + 0.5 * torch.randn((B, T, H), generator=gen, device=dev))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((B, T, H), generator=gen, device=dev) - 1)
        A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.3)
    Bm = (torch.randn((B, T, G, N), generator=gen, device=dev) * 0.5
          ).to(dtype)
    Cm = (torch.randn((B, T, G, N), generator=gen, device=dev) * 0.5
          ).to(dtype)
    return x, dt, A, Bm, Cm


def xbc_views(gen, B, T, H, P, N, dtype, ramp: bool, pad: int = 0):
    """x, dt, A, B, C with x, B and C as the SSD layer passes them: views
    into one (B, T, H P + 2 N + pad) xBC tensor (G 1)."""
    xbc = torch.randn((B, T, H * P + 2 * N + pad), generator=gen,
                      device="cuda").to(dtype)
    x, Bm, Cm, _ = torch.split(xbc, [H * P, N, N, pad], dim=-1)
    _, dt, A, _, _ = ssd_inputs(gen, B, T, H, 1, P, N, torch.float32, ramp)
    return (x.reshape(B, T, H, P), dt, A, Bm.reshape(B, T, 1, N),
            Cm.reshape(B, T, 1, N))


def phase_k3(card: str) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.kernels.ref import ssd_scan_plain
    gen = torch.Generator(device="cuda").manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    # (B, T, H, G, P, N, chunk, dtype): the sweep of tests/test_kernels.py
    # :133-177 (G < H included), zamba2-7b's widths, and its prefill shape
    # in float32 and bfloat16
    cases = [(2, 64, 4, 2, 16, 16, 16, f32), (2, 128, 4, 2, 32, 16, 32, f32),
             (2, 64, 4, 2, 16, 16, 64, f32), (2, 64, 4, 2, 16, 16, 16, bf16),
             (2, 64, 4, 1, 16, 16, 16, f32),
             (1, 1024, 112, 1, 64, 64, 128, f32),
             (1, PREFILL_T, 112, 1, 64, 64, 128, f32),
             (1, PREFILL_T, 112, 1, 64, 64, 128, bf16)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    zamba2_err = {}                           # max abs err at its shape
    tol_use = 0.0
    k3.reset_launch_count()
    for B, T, H, G, P, N, chunk, dtype in cases:
        ins = ssd_inputs(gen, B, T, H, G, P, N, dtype)
        err, use = compare(ops.ssd_scan(*ins, chunk=chunk),
                           ssd_scan_plain(*ins))
        key = str(dtype)[6:]
        worst[key] = max(worst[key], err)
        if T == PREFILL_T:
            zamba2_err[key] = err
        tol_use = max(tol_use, use)
        check(use <= 1, f"K3 differs from its plain version at B{B} T{T} H{H} "
                  f"G{G} P{P} N{N} Q{chunk} {key} (max abs err {err})")
    # x, B and C as the SSD layer passes them: views into one xBC tensor
    ins = xbc_views(gen, 1, 512, 8, 64, 64, f32, ramp=False)
    err, use = compare(ops.ssd_scan(*ins), ssd_scan_plain(*ins))
    check(use <= 1, f"K3 on strided xBC views (max abs err {err})")
    worst["float32"] = max(worst["float32"], err)
    tol_use = max(tol_use, use)
    sweep_launches = k3.launch_counts()

    # the tensor-core variant: bf16 cases against the float32 plain
    # version of the same bf16 inputs, each row within ROW_REL_TOL
    # (name, (B, T, H, G, chunk, ramp)), P = N = 64
    tc_cases = [("tc T256 Q128", (2, 256, 4, 1, 128, False)),
                ("tc T256 Q128 ramp", (2, 256, 4, 1, 128, True)),
                ("tc T1024 G2 Q128 ramp (8 chunks)",
                 (1, 1024, 8, 2, 128, True)),
                ("tc T512 G4 Q64 ramp (8 chunks)", (2, 512, 16, 4, 64, True)),
                ("tc T64 Q64 (one chunk)", (2, 64, 4, 1, 64, False))]
    runs = [(name, ssd_inputs(gen, B, T, H, G, 64, 64, bf16, ramp), chunk)
            for name, (B, T, H, G, chunk, ramp) in tc_cases]
    runs.append(("tc xBC views ramp",
                 xbc_views(gen, 1, 512, 8, 64, 64, bf16, ramp=True), 128))
    tc_abs = tc_row = tc_use = 0.0
    k3.reset_launch_count()
    for name, ins, chunk in runs:
        got = ops.ssd_scan(*ins, chunk=chunk)
        want = ssd_scan_plain(*(t.float() for t in ins))
        abs_err, row_err = attention_errors(got, want)
        _, use = compare(got, want, bf16)
        tc_abs, tc_row = max(tc_abs, abs_err), max(tc_row, row_err)
        tc_use = max(tc_use, use)
        check(use <= 1 and row_err <= ROW_REL_TOL,
              f"K3 tensor-core variant differs from the float32 plain "
              f"version on {name} (max abs err {abs_err}, worst row "
              f"error {row_err})")
    tc_launches = k3.launch_counts()
    check(tc_launches == {"tensor_core": len(runs), "simt": 0},
          f"the bf16 cases launched {tc_launches}, expected all "
          f"{len(runs)} on the tensor-core variant")

    # a bf16 call that TMA cannot read raises and launches nothing
    buf = torch.randn(2 * 128 * 4 * 64 + 1, device="cuda").to(bf16)
    x_off = buf[1:].view(2, 128, 4, 64)
    _, dt, A, Bm, Cm = ssd_inputs(gen, 2, 128, 4, 1, 64, 64, bf16)
    misaligned = {"x pointer one element off": (x_off, dt, A, Bm, Cm),
                  "xBC T stride of 1,288 bytes": xbc_views(
                      gen, 1, 128, 8, 64, 64, bf16, ramp=False, pad=4)}
    k3.reset_launch_count()
    raised = []
    for name, bad in misaligned.items():
        try:
            k3.ssd_scan_fwd(*bad)
        except ValueError:
            raised.append(name)
    check(raised == list(misaligned) and k3.launch_count() == 0,
          f"misaligned bf16 views: raised on {raised} of "
          f"{list(misaligned)}, {k3.launch_count()} launches")

    # the zamba2-7b shape with the model's ramps: the tensor-core variant
    # within K3_TC_ERR_FACTOR of the SIMT variant, both against the
    # float32 plain version; the SIMT variant computes the same function
    # at chunk 32, where route() sends bf16
    B, T, H, G, P, N, Q = PREFILL_B, PREFILL_T, 112, 1, 64, 64, 128
    ins = ssd_inputs(gen, B, T, H, G, P, N, bf16, ramp=True)
    want = ssd_scan_plain(*(t.float() for t in ins))
    k3.reset_launch_count()
    tc_z_abs, tc_z_row = attention_errors(k3.ssd_scan_fwd(*ins, chunk=Q),
                                          want)
    simt_z_abs, simt_z_row = attention_errors(
        k3.ssd_scan_fwd(*ins, chunk=32), want)
    check(k3.launch_counts() == {"tensor_core": 1, "simt": 1},
          f"zamba2 gate launches {k3.launch_counts()}")
    gate = {"tc_max_abs_err": tc_z_abs, "simt_max_abs_err": simt_z_abs,
            "tc_worst_row_rel_err": tc_z_row,
            "simt_worst_row_rel_err": simt_z_row,
            "y_max_abs": float(want.abs().max()),
            "inputs": "the model's dt and A ramps",
            "simt_chunk": 32,
            "reference": "ssd_scan_plain on float32 copies of the bf16 "
                         "inputs",
            "limit": f"tensor core <= {K3_TC_ERR_FACTOR} x SIMT, each; "
                     f"row <= {ROW_REL_TOL}"}
    check(tc_z_abs <= K3_TC_ERR_FACTOR * simt_z_abs
          and tc_z_row <= K3_TC_ERR_FACTOR * simt_z_row
          and tc_z_row <= ROW_REL_TOL,
          f"K3 at the zamba2 shape is less accurate than allowed: {gate}")
    del want
    torch.cuda.empty_cache()

    ins = ssd_inputs(gen, B, T, H, G, P, N, bf16)
    ms = time_cuda(lambda: k3.ssd_scan_fwd(*ins, chunk=Q), 20, 2)
    dev_ms, kernels = device_ms(lambda: k3.ssd_scan_fwd(*ins, chunk=Q))
    kernel_dev_ms = sum(v for k, v in kernels.items() if K3_TC_KERNEL in k)
    check(kernel_dev_ms > 0, f"the profile misses K3's tensor-core kernel: "
                             f"{kernels}")
    plain_ms = time_cuda(lambda: ssd_scan_plain(*ins), 2, 0)
    tri = Q * (Q + 1) // 2                    # lower-triangle (t, u) pairs
    macs = B * H * (T // Q) * (tri * N + tri * P + 2 * Q * N * P)
    nbytes = 2 * B * T * H * P * 2 + B * T * H * 4 + H * 4 \
        + 2 * B * T * G * N * 2
    out = {"card": card, "cases": len(cases) + 1 + len(runs),
           "max_abs_err": max(worst.values()),
           "max_abs_err_by_dtype": worst, "tolerance": "rtol = atol = "
           "1e-4 (float32), 2e-2 (bfloat16)", "tolerance_used": tol_use,
           "zamba2_shape_max_abs_err": zamba2_err,
           "tensor_core_vs_float32": {
               "cases": len(runs), "max_abs_err": tc_abs,
               "worst_row_rel_err": tc_row, "tolerance_used": tc_use,
               "row_rel_tol": ROW_REL_TOL},
           "zamba2_gate": gate, "misaligned_raised": raised,
           "launches_by_variant": {"sweep": sweep_launches,
                                   "tensor_core_cases": tc_launches},
           "variant": "tensor_core",
           "shape": {"B": B, "T": T, "H": H, "G": G, "P": P, "N": N,
                     "chunk": Q, "dtype": "bfloat16 (dt, A float32)"},
           "ms": ms, "device_ms": dev_ms,
           "kernel_device_ms": kernel_dev_ms,
           "device_ms_by_kernel": {k[:80]: v for k, v in kernels.items()},
           "plain_ms": plain_ms, "library_ms": None,
           "library_device_ms": None,
           "library": "none: no single PyTorch call computes the scan",
           **bound(nbytes, 2 * macs, bf16)}
    emit("k3", **out)
    return out


def phase_lm_parity(card: str) -> dict:
    """zamba2-7b at full width, depth cut to 6 layers (one shared-block
    application), float32: prefill on the card through K2 and K3 against
    the same parameters' prefill on the CPU through the plain versions."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.models import LM, build_model, prefill
    torch.backends.cuda.matmul.allow_tf32 = False    # full float32
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=6,
                              dtype="float32")
    t0 = time.perf_counter()
    on_card = build_model(cfg, seed=0)
    on_cpu = LM(cfg, torch.device("cpu"))
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    setup_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 256)))
    k2.reset_launch_count()                   # the main path's run only
    k3.reset_launch_count()
    t0 = time.perf_counter()
    got = prefill(on_card, {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = (k2.launch_count(), k3.launch_count())
    k2_variants = k2.launch_counts()
    k3_variants = k3.launch_counts()
    t0 = time.perf_counter()
    want = prefill(on_cpu, {"tokens": tokens})
    cpu_s = time.perf_counter() - t0
    got = got.cpu()
    err = float((got - want).abs().max())
    del on_card, on_cpu
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(got).all()), "6-layer logits not finite")
    check(launches == (1, 6), f"6-layer prefill launched K2, K3 "
                              f"{launches} times, expected (1, 6)")
    check(k2_variants["simt"] == 1, f"the float32 prefill's K2 call took "
                                    f"{k2_variants}, expected the SIMT "
                                    f"variant")
    check(k3_variants == {"tensor_core": 0, "simt": 6},
          f"the float32 prefill's K3 calls took {k3_variants}, expected "
          f"all 6 on the SIMT variant")
    check(torch.allclose(got, want, rtol=1e-3, atol=1e-3),
          f"6-layer prefill: card differs from CPU (max abs err {err})")
    out = {"card": card, "config": "zamba2-7b, n_layers 6, float32",
           "B": 1, "T": 256, "k2_launches": launches[0],
           "k2_launches_by_variant": k2_variants,
           "k3_launches": launches[1],
           "k3_launches_by_variant": k3_variants, "max_abs_err": err,
           "logit_scale": float(want.abs().max()),
           "tolerance": "rtol = atol = 1e-3", "setup_s": setup_s,
           "card_s_first_call": card_s, "cpu_s": cpu_s}
    emit("lm_parity", **out)
    return out


def phase_prefill(card: str) -> dict:
    """zamba2-7b at full width and depth, bf16 compute over float32
    parameters: one warm-up, three timed prefills (the first counted),
    and a profiled one."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.models import build_model, param_count, prefill
    cfg = get_config("zamba2-7b")
    spec = SHAPES["prefill_32k"]
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_T), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(2))}
    prefill(model, batch)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for run in range(3):
        if run == 0:
            k2.reset_launch_count()           # the main path's run only
            k3.reset_launch_count()
        t0 = time.perf_counter()
        logits = prefill(model, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if run == 0:
            launches = (k2.launch_count(), k3.launch_count())
            k2_variants = k2.launch_counts()
            k3_variants = k3.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(tuple(logits.shape) == (PREFILL_B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "zamba2-7b prefill logits not finite or of the wrong shape")
    check(launches == (14, 81), f"zamba2-7b prefill launched K2, K3 "
                                f"{launches} times, expected (14, 81)")
    check(k2_variants == {"tensor_core": 14, "simt": 0},
          f"zamba2-7b prefill's K2 launches by variant {k2_variants}, "
          f"expected all 14 on the tensor-core variant")
    check(k3_variants == {"tensor_core": 81, "simt": 0},
          f"zamba2-7b prefill's K3 launches by variant {k3_variants}, "
          f"expected all 81 on the tensor-core variant")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(model, batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    by_name = kernel_ms(prof)
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw no device time in the prefill")
    k2_ms = sum(v for k, v in by_name.items() if K2_KERNEL in k)
    k3_ms = sum(v for k, v in by_name.items() if K3_KERNEL in k)
    k3_tc_ms = sum(v for k, v in by_name.items() if K3_TC_KERNEL in k)
    check(k3_tc_ms > 0 and abs(k3_tc_ms - k3_ms) <= 1e-6 * k3_ms,
          f"the prefill profile's K3 time {k3_ms} ms is not all its "
          f"tensor-core kernel's ({k3_tc_ms} ms)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    median = sorted(seconds)[1]
    out = {"card": card, "config": "zamba2-7b, 81 layers, full width",
           "params": n_params, "param_count_analytic": param_count(cfg),
           "dtype": "bfloat16 compute, float32 parameters",
           "B": PREFILL_B, "T": PREFILL_T,
           "reduced": {"global_batch": f"{spec.global_batch} -> {PREFILL_B}",
                       "seq_len": f"{spec.seq_len} -> {PREFILL_T}",
                       "why": "the run's time limit and the simple kernels"},
           "init_s": init_s, "seconds": seconds, "median_s": median,
           "tokens_per_s": PREFILL_B * PREFILL_T / median,
           "peak_mem_bytes": peak, "k2_launches": launches[0],
           "k2_launches_by_variant": k2_variants,
           "k3_launches": launches[1],
           "k3_launches_by_variant": k3_variants,
           "profile": {"wall_ms": prof_wall * 1e3, "device_ms": busy,
                       "idle_share": 1.0 - busy / (prof_wall * 1e3),
                       "k2_ms": k2_ms, "k3_ms": k3_ms,
                       "rest_ms": busy - k2_ms - k3_ms,
                       "k2_share": k2_ms / busy, "k3_share": k3_ms / busy,
                       "rest_share": (busy - k2_ms - k3_ms) / busy,
                       "top": [{"name": k[:80], "device_ms": v}
                               for k, v in top]}}
    del model
    torch.cuda.empty_cache()
    emit("zamba2_prefill", **out)
    return out


def kernel_entry(name: str, source: str, replaces: str, launches: int,
                 phase: dict) -> dict:
    """One kernel of the table line; ``variant`` names the one the main
    path ran where the kernel has more than one; ``ms`` is on CUDA
    events around back-to-back calls, ``device_ms`` on the device's
    clock (the profiler's kernel time per call)."""
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "variant": phase.get("variant"),
            "matches_plain": True, "max_abs_err": phase["max_abs_err"],
            "ms": phase["ms"], "device_ms": phase["device_ms"],
            "plain_ms": phase["plain_ms"],
            "bound_ms": phase["bound_ms"], "bound_by": phase["bound_by"],
            "library_ms": phase["library_ms"],
            "library_device_ms": phase["library_device_ms"]}


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
    card = env["card"]
    if args.plan_only:
        phase_full(card)
        return 0
    k1 = phase_k1()
    phase_small()
    full = phase_full(card)
    phase_full(card, scale=2)
    phase_no_sync()
    k2 = phase_k2(card)
    k3 = phase_k3(card)
    phase_lm_parity(card)
    pre = phase_prefill(card)
    print(json.dumps({"kernels": [
        kernel_entry("masked_select", "masked_select.cu",
                     "src/repro/kernels/select_move.py:44",
                     full["k1_launches"], k1),
        kernel_entry("flash_attention", "flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:87",
                     pre["k2_launches"], k2),
        kernel_entry("ssd_scan", "ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:66",
                     pre["k3_launches"], k3)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
