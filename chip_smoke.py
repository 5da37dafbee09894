#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Builds every CUDA kernel of the port (K1, K2, K3) from
``src/repro_torch/csrc`` into ``build/repro_torch/``, then runs these
phases, one JSON line each, and exits non-zero if any fails:

0. environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions, the kernel build time; K1's fused kernel
   ``select_rows_kernel`` keeps float64 rounding: its PTX (``nvcc -ptx``)
   has no float64 ``fma`` and no add, subtract or multiply without
   ``.rn``, and every DFMA of its SASS belongs to one of its divisions;
   ``cuobjdump -sass`` of K2's library and of each of K3's four
   tensor-core instantiations (chunk 64 and 128 by state width 64 and
   128) must show ``HGMMA`` (the tensor-core kernels are on the tensor
   cores), and the registers, stack and spills of each tensor-core kernel
   from the ``-Xptxas -v`` report (K3's with no spills);
1. kernel K1: the fused ``select_rows`` against its plain PyTorch
   version on the card, bitwise (``any``, ``dst``, ``cand_src``), on the
   planner carries of ``tests/_select_rows_carries.py`` (three paper
   clusters, source bounds on and off, parked sources, the knife's edge
   of the variance test on each side) and on cluster B's first step,
   staged and from device memory; its kernel, plain and bound times
   there (the bound counted from that carry's data); then the standalone
   reduction ``masked_select`` against its plain version, bitwise, over
   shapes, dtypes, densities, a tie-break row and all-invalid rows, with
   kernel, plain, library-call and bound times at the cluster-B step
   shape;
2. bit-identity on the card: ``equilibrium_batch`` on CUDA against the
   port's host ``equilibrium_faithful`` on four small paper clusters,
   source bounds on and off, chunk 1 and 64, plus a row-capacity
   boundary case that forces a re-pad;
3. full size: a cold plan of the paper's cluster B (995 OSDs, 8,731 PGs,
   58,961 shards) to convergence on the card, held to the committed
   ``BENCH_planner.json`` row ``planner.tail.B1x.batch`` (moves, the
   sources-tried histogram, bound hits, pruned sources), one host sync
   per chunk, K1's ``select_rows`` launched exactly once a step and the
   standalone reduction never; the first 200 moves held to the port's
   host faithful planner; a profiled first chunk (device operations a
   step, busy seconds, idle share, K1's device time);
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
   bound times; at mamba2-2.7b's shape (H 80, P 64, N 128, chunk 128,
   the ramps) the tensor-core variant in bf16 (each row within 1e-2 of
   the float32 plain version, its max abs and worst row error within 4 x
   the SIMT variant's on the same inputs) and the SIMT variant in
   float32 (1e-4), each with its kernel, plain and bound times; the
   tensor-core workspace (``workspace_bytes``) at the
   zamba2 cell and at B 32, T 32768, H 112, and one tensor-core call at
   B 1, T 32768, H 112 against the plain version, with the memory it
   allocated beyond its inputs and output;
7. zamba2-7b at full width, 6 layers, float32: prefill on the card
   (through K2 and K3, launched 1 and 6 times) against the same
   parameters on the CPU (plain versions), rtol = atol = 1e-3; K2 and
   K3 on their SIMT variants;
8. zamba2-7b at full width and depth, bf16, B 1, T 4096 (the registry's
   ``prefill_32k`` cut from B 32, S 32768): finite logits, K2 launched
   14 times and K3 81 times, all on their tensor-core variants, seconds,
   tokens/s, peak memory and the profiled device-time shares of K2, K3
   (all of it the tensor-core kernel) and the rest, the profile holding
   every one of the run's K2 and K3 launches;
9. mamba2-2.7b at full width, 4 layers, float32: prefill on the card
   (K3 launched 4 times, SIMT; K2 never) against the same parameters on
   the CPU, rtol = atol = 1e-3;
10. mamba2-2.7b at full width and depth (64 layers, 2,702,579,200
    float32 parameters), bf16, B 1, T 4096 (the same cut as phase 8):
    finite (1, 50280) logits, K3 launched 64 times, all on the
    tensor-core variant (N 128), none SIMT, K2 never; seconds, tokens/s,
    peak memory and the profiled device-time shares of K3 (all of it the
    tensor-core kernel) and the rest, as in phase 8;
11. the kernel table line (K1 once: ``select_rows``'s launches and
    times, and the standalone reduction's beside them; K3 once: the
    tensor-core variant's launches and times at the zamba2 prefill, and
    beside them its N 128 instantiation's and the SIMT variant's at
    mamba2's shape); the last line names the device.

Kernel times come in two forms: ``ms``, CUDA events around calls the
host issues back to back, and ``device_ms``, CUDA events around calls
queued behind a sleep kernel, which the host's issue rate cannot set.
The prefills' profiles must hold every K2 and K3 launch the run counted:
the H100's profiler drops whole calls' records from some sessions, so a
session that lost any is run again, three sessions at most; the sessions
each profile took are printed before the kernel table line.

``--plan-only`` runs phases 0 and 3 (scale 1) alone and prints no result
line: the way to time two trees in turns within one run on one card.

It imports only ``repro_torch``, the tests' planner carries
(``tests/_select_rows_carries.py``, which import only ``repro_torch``),
torch, NumPy and the standard library.
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
#: clock cycles of the sleep kernel that holds the stream while the host
#: queues the calls :func:`device_ms` times (about 0.1 s at the H100's
#: clock)
SLEEP_CYCLES = 200_000_000
#: profile sessions tried for one measurement before the run fails for
#: lost launch records (:func:`profiled`), and each measurement's count
PROFILE_TRIES = 3
PROFILE_LOG: list[dict] = []
#: K1's fused kernel as the profiler names it
K1_KERNEL = "select_rows_kernel"
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


def kernel_rows(prof) -> dict[str, tuple[float, int]]:
    """Device milliseconds and recorded launches by kernel name in a
    profile."""
    rows: dict[str, tuple[float, int]] = {}
    for ev in prof.key_averages():
        if str(ev.device_type) != "DeviceType.CUDA":
            continue                    # host-side rows; kernels below
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        ms, n = rows.get(ev.key, (0.0, 0))
        rows[ev.key] = (ms + us / 1e3, n + ev.count)
    return rows


def matching(rows: dict[str, tuple[float, int]], pattern: str
             ) -> tuple[float, int]:
    """Milliseconds and launches of the rows whose name holds
    ``pattern``."""
    hits = [v for k, v in rows.items() if pattern in k]
    return sum(ms for ms, _ in hits), sum(n for _, n in hits)


def profiled(run, missing, what: str
             ) -> tuple[dict[str, tuple[float, int]], float]:
    """:func:`kernel_rows` of a profile of ``run()`` (which ends in a
    synchronize) and its wall seconds.  ``missing(rows)`` holds the
    launches the profile recorded to the launches ``run()`` made and
    says what is missing, or returns None.  On the H100 the profiler
    drops the records of whole calls from some sessions, and of every
    call from a few (PERF.md §6): a session that misses any launch is run
    again, up to :data:`PROFILE_TRIES` sessions in all, and the run fails
    if none holds every launch.  No number comes from a session that
    lost records.  Each profile's sessions go to :data:`PROFILE_LOG`."""
    from torch.profiler import ProfilerActivity, profile
    for n in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
        rows = kernel_rows(prof)
        gap = missing(rows)
        if gap is None:
            PROFILE_LOG.append({"profile": what, "sessions": n})
            return rows, wall
        print(f"chip_smoke: profile session {n} of {what} lost launch "
              f"records: {gap}", file=sys.stderr, flush=True)
    fail(f"{PROFILE_TRIES} profile sessions of {what} all lost launch "
         f"records; the last: {gap}")


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call: CUDA events around ``iters`` calls of
    ``fn`` that the host queues while a sleep kernel holds the stream, so
    that the device runs them back to back and the host's issue rate
    cannot set the time (:func:`time_cuda` reads that rate where a call
    is shorter than its issue).  Fails if the host took longer to queue
    the calls than the sleep lasted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    held, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    held.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    sleep_ms = held.elapsed_time(start)
    check(issue_ms < sleep_ms, f"the host took {issue_ms} ms to queue "
                               f"{iters} calls, longer than the "
                               f"{sleep_ms} ms sleep that held them")
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds to issue one call of ``fn``, timed on the host's
    clock while a sleep kernel holds the stream, so no call waits on the
    device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


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
    ptx = k1_ptx_start(build)
    reports = build.build()
    build_s = time.perf_counter() - t0
    for name, log in reports.items():
        print(f"[ptxas {name}]\n{log.strip()}", file=sys.stderr)
    env = {"card": card, "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "kernels_built": sorted(reports), "build_s": build_s,
           **k1_instructions(build, ptx), **k2_instructions(build),
           **k3_instructions(build)}
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


def sass_of(build, name: str) -> str:
    """``cuobjdump -sass`` of ``csrc/<name>.cu``'s library."""
    lib = build.library_path(name)
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump -sass {lib.name} failed: "
                                f"{sass.stderr.strip()[-400:]}")
    return sass.stdout


def sass_hgmma(build, name: str, kernel: str) -> int:
    """HGMMA (wgmma) instructions in ``cuobjdump -sass`` of
    ``csrc/<name>.cu``'s library; fails at none."""
    hgmma = len(re.findall(r"\bHGMMA\b", sass_of(build, name)))
    check(hgmma > 0, f"{kernel}'s library has no HGMMA instruction: the "
                     f"tensor-core kernel does not run on the tensor cores")
    return hgmma


#: select_rows_kernel's float64 arithmetic in PTX: every add, subtract
#: and multiply carries an explicit rounding mode, which ptxas may not fuse
#: into an FMA (PTX ISA, ``add``/``mul``); no ``fma`` is there to begin
#: with
PTX_F64_OP = re.compile(r"\b(add|sub|mul|fma|div)((?:\.\w+)*)\.f64\b")
#: instructions after a division's MUFU.RCP64H within which its DFMAs (the
#: reciprocal's Newton steps and the quotient's correction) must lie
DIV_WINDOW = 24


def k1_ptx_start(build) -> subprocess.Popen:
    """``nvcc -ptx`` of K1's source with the library's flags, started
    beside the build: the library holds SASS only."""
    out = build.BUILD_DIR / "masked_select.ptx"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    flags = [f.replace("code=sm_90a", "code=compute_90a") for f in flags]
    return subprocess.Popen(
        [build.nvcc_path(), *flags, "-ptx", "-o", str(out),
         str(build.CSRC / "masked_select.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def sass_functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """(address, instruction) of each function in ``cuobjdump -sass``
    output, by mangled name."""
    out, name = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = m.group(1)
            out[name] = []
        elif name and (m := re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;",
                                     line)):
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def division_only_dfma(ins: list[tuple[int, str]]) -> dict:
    """Where the DFMAs of one kernel's SASS lie.  A correctly rounded
    float64 division on sm_90 is MUFU.RCP64H, Newton steps and a
    correction in DFMA, and a call into a slow-path subroutine for
    operands near the range's ends; no other DFMA may appear: each one in
    the kernel's own code must lie within :data:`DIV_WINDOW` instructions
    after a MUFU.RCP64H, and every division must hold the same number, so
    a contracted multiply-add would show as a stray or a surplus."""
    targets = [int(m.group(1), 16) for _, text in ins
               if (m := re.match(r"CALL\.REL\S*\s+0x([0-9a-f]+)", text))]
    sub = min(targets, default=float("inf"))  # the called subroutine
    body = [text for addr, text in ins if addr < sub]
    rcp = [i for i, text in enumerate(body) if "MUFU.RCP64H" in text]
    per, stray = dict.fromkeys(rcp, 0), 0
    for i, text in enumerate(body):
        if not re.search(r"\bDFMA\b", text):
            continue
        owner = max((r for r in rcp if r < i), default=None)
        if owner is None or i - owner > DIV_WINDOW:
            stray += 1
        else:
            per[owner] += 1
    return {"divisions": len(rcp), "dfma_per_division": sorted(
                set(per.values())), "stray_dfma": stray,
            "slow_path_dfma": sum(bool(re.search(r"\bDFMA\b", text))
                                  for addr, text in ins if addr >= sub)}


def k1_instructions(build, ptx: subprocess.Popen) -> dict:
    """``select_rows_kernel`` keeps the plain version's float64 rounding:
    in its PTX no float64 ``fma`` and no add, subtract or multiply without
    ``.rn``; in its SASS every DFMA is a division's own
    (:func:`division_only_dfma`), as many divisions as PTX's
    ``div.rn.f64``; and the registers and spills of each kernel of the
    library."""
    log, _ = ptx.communicate()
    check(ptx.returncode == 0, f"nvcc -ptx of K1 failed:\n{log[-2000:]}")
    text = (build.BUILD_DIR / "masked_select.ptx").read_text()
    entries = {m.group(1): body for m, body in zip(
        re.finditer(r"\.entry (\S+?)\(", text),
        re.split(r"\.entry \S+?\(", text)[1:])}
    sass = sass_functions(sass_of(build, "masked_select"))
    ptxas = ptxas_kernels(build.ptxas_report("masked_select"))
    out = {}
    for name, body in entries.items():
        if "select_rows_kernel" not in name:
            continue
        ops = [(m.group(1), m.group(2)) for m in PTX_F64_OP.finditer(body)]
        unrounded = sum(op in ("add", "sub", "mul") and ".rn" not in mods
                        for op, mods in ops)
        fma = sum(op == "fma" for op, _ in ops)
        div = sum(op == "div" and ".rn" in mods for op, mods in ops)
        dfma = division_only_dfma(sass[name])
        key = "staged" if "ILb1E" in name else "device_memory"
        out[key] = {"ptx_f64_ops": len(ops), "ptx_fma_f64": fma,
                    "ptx_f64_without_rn": unrounded,
                    "ptx_div_rn_f64": div, **dfma, **ptxas.get(name, {})}
        check(fma == 0 and unrounded == 0 and div > 0,
              f"select_rows_kernel ({key}) PTX holds float64 arithmetic "
              f"that may be contracted: {out[key]}")
        check(dfma["stray_dfma"] == 0 and dfma["divisions"] == div
              and len(dfma["dfma_per_division"]) == 1,
              f"select_rows_kernel ({key}) SASS holds a DFMA outside its "
              f"divisions: {out[key]}")
    check(set(out) == {"staged", "device_memory"},
          f"K1's PTX lists select_rows_kernel as {sorted(out)}")
    return {"k1_select_rows_instructions": out}


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


#: K3's tensor-core kernel by chunk Q and state width N, in a mangled name
K3_TC_MANGLED = re.compile(r"ssd_scan_kernel_tcILi(\d+)ELi(\d+)E")


def k3_instructions(build) -> dict:
    """K3's library on the tensor cores: the four tensor-core
    instantiations (chunk Q 64 and 128, state width N 64 and 128) must
    each hold HGMMA in ``cuobjdump -sass``; the registers, stack and
    spills of each from the ``-Xptxas -v`` report, none of which may
    spill."""
    def key(name):
        m = K3_TC_MANGLED.search(name)
        return m and f"Q{m.group(1)}_N{m.group(2)}"
    per_kernel = {key(name): sum(bool(re.search(r"\bHGMMA\b", ins))
                                 for _, ins in body)
                  for name, body in sass_functions(
                      sass_of(build, "ssd_scan")).items() if key(name)}
    log = build.ptxas_report("ssd_scan")
    tc = {key(name): stats for name, stats in ptxas_kernels(log).items()
          if key(name)}
    want = {f"Q{q}_N{n}" for q in (64, 128) for n in (64, 128)}
    check(set(tc) == want and set(per_kernel) == want,
          f"the ptxas report lists K3's tensor-core instantiations "
          f"{sorted(tc)} and the SASS {sorted(per_kernel)}, expected "
          f"{sorted(want)}")
    check(all(per_kernel.values()), f"K3 tensor-core instantiations "
                                    f"without HGMMA: {per_kernel}")
    spilled = {k: v for k, v in tc.items()
               if v.get("spill_stores") or v.get("spill_loads")}
    check(not spilled, f"K3's tensor-core kernels spill: {spilled}")
    return {"k3_sass_hgmma": sum(per_kernel.values()),
            "k3_sass_hgmma_by_kernel": dict(sorted(per_kernel.items())),
            "k3_tensor_core_ptxas": dict(sorted(tc.items())),
            "k3_wgmma_serialized": [line.strip() for line in
                                    log.splitlines()
                                    if "serializ" in line]}


# ---------------------------------------------------------------------------
# phase 1


def k1_masked_select() -> dict:
    """K1's standalone reduction, ``masked_select_fwd``, against its plain
    version, bitwise; its times at the cluster-B step's mask shape."""
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
    k_dev = device_ms(lambda: masked_select_fwd(v, u), 50)
    lib_dev = device_ms(lambda: torch.where(v, u, inf).min(dim=1), 50)
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
    emit("k1_masked_select", **out)
    return out


#: float64 and int32 operations an H100 SXM completes a second: 132 SMs x
#: 64 FP64 (or INT32) units x the 1.98 GHz boost clock, one operation per
#: unit per cycle with no FMA to pair them (half the data sheet's 34
#: TFLOP/s of float64 FMA)
F64_OPS_PER_S = INT_OPS_PER_S = 132 * 64 * 1.98e9


def select_rows_work(args: tuple, div_ops: int) -> dict:
    """The operations and bytes that ``select_rows_kernel`` needs on this
    carry, counted as the kernel does the work (the masks of
    ``select_rows_masks``, the kernel's order): per (row, device) pair of a
    live row, the capacity add and three float64 compares and six integer
    tests; per pair that passes them, 2 S integer compares against the
    acting slots; per candidate, the variance test's 11 float64 adds,
    subtracts and multiplies, one compare and three divisions of
    ``div_ops`` float64 instructions each; per legal pair, one compare.
    Bytes: the (n,) device vectors and the destination-count table read
    once, each row's carry entries once, the outputs written once."""
    from repro_torch.kernels.ref import select_rows_masks
    m = select_rows_masks(*args)
    src_order, _, _, dyn, const, _ = args
    k, R, n = m["cand"].shape
    S, L = dyn["acting"].shape[1], const["dev_domain"].shape[0]
    P = dyn["dst_ok"].shape[0]
    live = int(m["live"].sum()) * n
    pre, cand, valid = (int(m[key].sum()) for key in ("pre", "cand", "valid"))
    f64 = 4 * live + (12 + 3 * div_ops) * cand + valid
    ints = 6 * live + 2 * S * pre
    nbytes = (n * (5 * 8 + 1 + 8 * L) + P * n
              + k * R * (8 + 2 * 8 + 8 * 8 + 8 * S) + k * R * 5 + 9 * k)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(f64 / F64_OPS_PER_S, ints / INT_OPS_PER_S) * 1e3
    return {"shape": {"k": k, "R": R, "n": n, "S": S, "L": L},
            "live_pairs": live, "pairs_to_slot_tests": pre,
            "candidate_pairs": cand, "legal_pairs": valid,
            "f64_ops": f64, "int_ops": ints, "div_f64_instructions": div_ops,
            "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_k1(card: str, base_b, env: dict) -> dict:
    """K1's fused selection ``select_rows_fwd`` against its plain version
    on the card, bitwise (any, dst, cand_src), on the test carries
    (``tests/_select_rows_carries.py``: three paper clusters, source
    bounds on and off, parked sources, the knife's edge of the variance
    test on each side) and on the first step of cluster B (staged and
    from device memory); its kernel, plain and bound times at cluster B's
    first step; then the standalone ``masked_select_fwd``."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _select_rows_carries import (CARRIES, carry, carry_id, knife_edge,
                                      to_device)
    from repro_torch.core.equilibrium_batch import BatchPlanner
    from repro_torch.kernels import select_move
    from repro_torch.kernels.ref import select_rows_ref
    dev = torch.device("cuda")
    cases = [(carry_id(c), carry(*c)) for c in CARRIES]
    cases += [(f"knife edge {c} {'inside' if inside else 'on'}",
               knife_edge(carry(c, 0, True, False), inside)[0])
              for c in ("small_test_cluster", "cluster_d")
              for inside in (False, True)]
    planner = BatchPlanner(base_b.copy(), device="cuda")
    planner.sync()
    step = planner._step
    _, src_order, n_avail = step.sources()
    args_b = (src_order, n_avail, step.cap_lim, step.dyn, step.const,
              step.scal)
    cases.append(("cluster_b-step0", args_b))
    select_move.reset_launch_count()
    worst = 0
    for name, args in cases + [("cluster_b-step0 device memory", args_b)]:
        args = to_device(args, dev)
        got = select_move.select_rows_fwd(
            *args, smem_limit=0 if "device memory" in name else None)
        want = select_rows_ref(*args)
        torch.cuda.synchronize()
        err = int((got[1].long() - want[1].long()).abs().max())
        worst = max(worst, err)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"select_rows differs from its plain version on {name} (max "
              f"|dst diff| {err}, any {torch.equal(got[0], want[0])}, "
              f"cand_src {torch.equal(got[2], want[2])})")
    check(select_move.launch_counts()["select_rows"] == len(cases) + 1,
          f"select_rows launches {select_move.launch_counts()}")

    ins = env["k1_select_rows_instructions"]["staged"]
    work = select_rows_work(args_b, ins["dfma_per_division"][0] + 1)
    # the staged variant (the rule) and the device-memory one (the path
    # for device vectors that do not fit) in turns, three each, each on
    # the carry bound once as the planner binds it; the kernel's times
    # are the staged variant's medians
    turns = {"staged": [], "device_memory": []}
    for _ in range(3):
        for name, limit in (("staged", None), ("device_memory", 0)):
            bound = select_move.SelectRows(*args_b[2:], smem_limit=limit)
            turns[name].append({
                "ms": time_cuda(lambda: bound(*args_b[:2])),
                "device_ms": device_ms(lambda: bound(*args_b[:2]), 50)})
    ms, dev_ms = (float(np.median([t[key] for t in turns["staged"]]))
                  for key in ("ms", "device_ms"))
    # the wrapper's host cost a call: bound once (the planner's way)
    # against checked and packed on every call
    bound = select_move.SelectRows(*args_b[2:])
    host = {"bound_us": host_us(lambda: bound(*args_b[:2])),
            "one_shot_us": host_us(
                lambda: select_move.select_rows_fwd(*args_b))}
    plain_ms = time_cuda(lambda: select_rows_ref(*args_b), 20, 2)
    # the plain version's ~150 launches take the host ~10 ms a call to
    # queue: three calls fit the sleep
    plain_dev_ms = device_ms(lambda: select_rows_ref(*args_b), 3, 1)
    out = {"card": card, "cases": len(cases) + 1, "max_abs_err": worst,
           "comparison": "bitwise: any, dst and cand_src",
           "at": "cluster B's first step", "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "plain_device_ms": plain_dev_ms,
           "library_ms": None, "library_device_ms": None,
           "library": "none: no single PyTorch call computes the selection",
           "variants": turns, "host": host, **work,
           "bound_note": f"operations over {F64_OPS_PER_S:.4g}/s each of "
                         f"float64 and int32; a division counted as its "
                         f"{work['div_f64_instructions']} float64 "
                         f"instructions (DFMA and DMUL) in phase 0's SASS"}
    emit("k1", **out)
    out["standalone"] = k1_masked_select()
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
    k1 = [(us, n) for us, key, n in rows if K1_KERNEL in key]
    return {"card": card, "chunk_steps": planner.chunk, "moves": moves,
            "wall_s": wall, "device_busy_s": busy_s if rows else None,
            "idle_share": (1.0 - busy_s / wall) if rows else None,
            "device_ops": ops, "device_ops_per_step": ops / planner.chunk,
            "k1_device_ms": sum(us for us, _ in k1) / 1e3,
            "k1_calls_recorded": sum(n for _, n in k1),
            "top": [{"name": k[:80], "device_ms": us / 1e3, "calls": n}
                    for us, k, n in rows[:12]]}


def build_cluster_b(scale: int = 1) -> tuple:
    """``cluster_b(scale)`` and the host seconds its build took."""
    from repro_torch.core.clustergen import cluster_b
    t0 = time.perf_counter()
    base = cluster_b(scale=scale)
    return base, time.perf_counter() - t0


def phase_full(card: str, scale: int = 1, built: tuple | None = None
               ) -> dict:
    """A cold plan of ``cluster_b(scale)`` (``built``: the cluster and its
    build seconds, where the caller built it)."""
    from repro_torch import obs
    from repro_torch.core.planner import create_planner
    from repro_torch.kernels import select_move
    want = bench_row(BENCH_ROWS[scale])
    base, build_s = built or build_cluster_b(scale)
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
    launches = select_move.launch_counts()
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
    steps = chunks * planner._impl.chunk
    check(launches == {"select_rows": steps, "masked_select": 0},
          f"K1 launched {launches} times over {chunks} chunks ({steps} "
          f"steps) of {n} moves, expected select_rows once a step")

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
           "repads": repads, "k1_launches": launches["select_rows"],
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
#: K2 (either variant) as the profiler names it
K2_KERNEL = "flash_fwd_kernel"
#: each K3 variant as the profiler names it (its template follows the
#: name; the tensor-core one's flags are zeroed by a fill kernel of the
#: wrapper's, outside the name)
K3_KERNELS = {"tensor_core": "ssd_scan_kernel_tc<",
              "simt": "ssd_scan_kernel<"}


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
    dev_ms = device_ms(lambda: k2.flash_attention_fwd(q, k, v))
    lib_dev_ms = device_ms(lambda: F.scaled_dot_product_attention(
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
    dev_ms = device_ms(lambda: k3.ssd_scan_fwd(*ins, chunk=Q))
    plain_ms = time_cuda(lambda: ssd_scan_plain(*ins), 2, 0)
    del ins
    torch.cuda.empty_cache()
    wide = k3_wide_state(gen)
    ring = k3_ring(gen)
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
           "plain_ms": plain_ms, "library_ms": None,
           "library_device_ms": None,
           "library": "none: no single PyTorch call computes the scan",
           **k3_bound(B, T, H, G, P, N, Q),
           "mamba2_shape": wide, "workspace": ring}
    emit("k3", **out)
    return out


def k3_bound(B, T, H, G, P, N, Q, dtype=torch.bfloat16) -> dict:
    """K3's least time at a shape whose x, B, C and y are ``dtype`` (dt
    and A float32): x and y, dt, B and C at group width moved once; the
    scores and y_intra over the lower triangle, y_inter and the state
    update at ``dtype``'s rate (bf16 on the tensor cores, float32 outside
    them)."""
    tri = Q * (Q + 1) // 2                    # lower-triangle (t, u) pairs
    macs = B * H * (T // Q) * (tri * N + tri * P + 2 * Q * N * P)
    size = torch.finfo(dtype).bits // 8
    nbytes = 2 * B * T * H * P * size + B * T * H * 4 + H * 4 \
        + 2 * B * T * G * N * size
    return bound(nbytes, 2 * macs, dtype)


#: mamba2-2.7b's SSD call in its prefill (B 1, T 4096): 80 heads, G 1,
#: P 64, N 128, chunk 128
MAMBA2_SSD = dict(B=PREFILL_B, T=PREFILL_T, H=80, G=1, P=64, N=128, Q=128)


def k3_wide_state(gen) -> dict:
    """K3 at mamba2-2.7b's shape on the model's ramps.  bf16, the
    prefill's dtype, takes the tensor-core variant: every (token, head)
    row within ROW_REL_TOL of the float32 plain version of the same
    inputs, and its max abs and worst row error within K3_TC_ERR_FACTOR of
    the SIMT variant's on those inputs (at chunk 32, where route() sends
    bf16); then its kernel, plain and bound times.  float32 keeps the SIMT
    variant: within rtol = atol = 1e-4 of the plain version, with its
    kernel and bound times."""
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.kernels.ref import ssd_scan_plain
    B, T, H, G, P, N, Q = MAMBA2_SSD.values()
    bf16, f32 = torch.bfloat16, torch.float32
    check(k3.route(bf16, P, N, Q) == "tensor_core"
          and k3.route(f32, P, N, Q) == "simt",
          "route sends mamba2's bf16 call off the tensor cores or its "
          "float32 call off the SIMT variant")
    ins = ssd_inputs(gen, B, T, H, G, P, N, bf16, ramp=True)
    want = ssd_scan_plain(*(t.float() for t in ins))
    k3.reset_launch_count()
    got = k3.ssd_scan_fwd(*ins, chunk=Q)
    tc_abs, tc_row = attention_errors(got, want)
    _, tc_use = compare(got, want, bf16)
    simt_abs, simt_row = attention_errors(k3.ssd_scan_fwd(*ins, chunk=32),
                                          want)
    check(k3.launch_counts() == {"tensor_core": 1, "simt": 1},
          f"mamba2-shape bf16 K3 launches {k3.launch_counts()}")
    gate = {"tc_max_abs_err": tc_abs, "simt_max_abs_err": simt_abs,
            "tc_worst_row_rel_err": tc_row, "simt_worst_row_rel_err":
            simt_row, "tolerance_used": tc_use,
            "y_max_abs": float(want.abs().max()),
            "simt_chunk": 32,
            "limit": f"tensor core <= {K3_TC_ERR_FACTOR} x SIMT, each; "
                     f"row <= {ROW_REL_TOL}"}
    check(tc_use <= 1 and tc_row <= ROW_REL_TOL
          and tc_abs <= K3_TC_ERR_FACTOR * simt_abs
          and tc_row <= K3_TC_ERR_FACTOR * simt_row,
          f"the tensor-core K3 at mamba2's shape is less accurate than "
          f"allowed: {gate}")
    del got, want
    tc = {"variant": "tensor_core", "errors": gate,
          "shape": {**MAMBA2_SSD, "dtype": "bfloat16 (dt, A float32)"},
          "ms": time_cuda(lambda: k3.ssd_scan_fwd(*ins, chunk=Q), 20, 2),
          "device_ms": device_ms(lambda: k3.ssd_scan_fwd(*ins, chunk=Q)),
          "plain_ms": time_cuda(lambda: ssd_scan_plain(*ins), 2, 0),
          "workspace_bytes": k3.workspace_bytes(B, H, T, P, N, Q),
          **k3_bound(B, T, H, G, P, N, Q)}

    ins = ssd_inputs(gen, B, T, H, G, P, N, f32, ramp=True)
    k3.reset_launch_count()
    got = k3.ssd_scan_fwd(*ins, chunk=Q)
    check(k3.launch_counts() == {"tensor_core": 0, "simt": 1},
          f"mamba2-shape float32 K3 launches {k3.launch_counts()}")
    want = ssd_scan_plain(*ins)
    abs_err, row_err = attention_errors(got, want)
    _, use = compare(got, want)
    check(use <= 1, f"SIMT K3 at mamba2's shape in float32 differs from "
                    f"the plain version: max abs err {abs_err}")
    del got, want
    simt = {"variant": "simt", "dtype": "float32",
            "errors": {"max_abs_err": abs_err, "worst_row_rel_err": row_err,
                       "tolerance_used": use},
            "smem_bytes": k3._library().ssd_scan_smem_bytes(Q, P, N),
            "ms": time_cuda(lambda: k3.ssd_scan_fwd(*ins, chunk=Q), 10, 2),
            "device_ms": device_ms(lambda: k3.ssd_scan_fwd(*ins, chunk=Q),
                                   10),
            "plain_ms": time_cuda(lambda: ssd_scan_plain(*ins), 2, 0),
            **k3_bound(B, T, H, G, P, N, Q, f32)}
    del ins
    torch.cuda.empty_cache()
    return {"tensor_core": tc, "simt_float32": simt,
            "tolerance": "bfloat16 (tensor core): each row <= "
                         f"{ROW_REL_TOL} of the float32 plain version and "
                         f"<= {K3_TC_ERR_FACTOR} x the SIMT variant's "
                         "error; float32 (SIMT): rtol = atol = 1e-4",
            "inputs": "the model's dt and A ramps"}


def k3_ring(gen) -> dict:
    """The tensor-core K3's workspace: :func:`workspace_bytes` at the
    zamba2 cell and at the registry's prefill_32k (B 32, T 32,768, H
    112), beside one slot per chunk as before the ring; then one call at
    B 1, T 32,768, H 112 (256 chunks a head, each ring slot written 128
    times) against the float32 plain version, with the memory it
    allocated beyond its inputs and output."""
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.kernels.ref import ssd_scan_plain
    P = N = 64
    Q = 128
    sizes = {}
    for name, (B, T, H) in (("zamba2_cell", (PREFILL_B, PREFILL_T, 112)),
                            ("prefill_32k", (32, 32768, 112))):
        sizes[name] = {"B": B, "T": T, "H": H,
                       "workspace_bytes": k3.workspace_bytes(B, H, T, P, N,
                                                             Q),
                       "one_slot_per_chunk_bytes": B * H * (T // Q) * P * N
                       * 4 + (B * H * (T // Q) + 1) * 4}
        emit("k3_workspace", **{"case": name, **sizes[name]})
    check(sizes["prefill_32k"]["workspace_bytes"] <= 128 * 2 ** 20,
          f"K3's workspace at prefill_32k: {sizes['prefill_32k']}")
    B, T, H = 1, 32768, 112
    ins = ssd_inputs(gen, B, T, H, 1, P, N, torch.bfloat16, ramp=True)
    k3.reset_launch_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = k3.ssd_scan_fwd(*ins, chunk=Q)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before \
        - got.numel() * got.element_size()
    check(k3.launch_counts() == {"tensor_core": 1, "simt": 0},
          f"T 32768 K3 launches {k3.launch_counts()}")
    want = ssd_scan_plain(*(t.float() for t in ins))
    abs_err, row_err = attention_errors(got, want)
    _, use = compare(got, want, torch.bfloat16)
    ws = k3.workspace_bytes(B, H, T, P, N, Q)
    long_call = {"B": B, "T": T, "H": H, "chunks_per_head": T // Q,
                 "max_abs_err": abs_err, "worst_row_rel_err": row_err,
                 "tolerance_used": use, "workspace_bytes": ws,
                 "allocated_beyond_inputs_output_bytes": extra}
    check(use <= 1 and row_err <= ROW_REL_TOL,
          f"tensor-core K3 at T 32768 differs from the float32 plain "
          f"version: {long_call}")
    check(extra <= ws + 2 ** 20, f"tensor-core K3 at T 32768 allocated "
                                 f"{extra} bytes beyond its inputs and "
                                 f"output, its workspace is {ws}")
    del ins, got, want
    torch.cuda.empty_cache()
    return {**sizes, "t32768_call": long_call}


def phase_lm_parity(card: str, arch: str = "zamba2-7b", n_layers: int = 6,
                    want: tuple[int, int] = (1, 6),
                    phase: str = "lm_parity") -> dict:
    """``arch`` at full width, depth cut to ``n_layers`` (zamba2: one
    shared-block application), float32: prefill on the card through K2
    and K3, launched ``want`` times, all on their SIMT variants, against
    the same parameters' prefill on the CPU through the plain versions."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.models import LM, build_model, prefill
    torch.backends.cuda.matmul.allow_tf32 = False    # full float32
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
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
    want_logits = prefill(on_cpu, {"tokens": tokens})
    cpu_s = time.perf_counter() - t0
    got = got.cpu()
    err = float((got - want_logits).abs().max())
    del on_card, on_cpu
    torch.cuda.empty_cache()
    what = f"{arch} {n_layers}-layer prefill"
    check(bool(torch.isfinite(got).all()), f"{what}: logits not finite")
    check(launches == want, f"{what} launched K2, K3 {launches} times, "
                            f"expected {want}")
    check(k2_variants == {"tensor_core": 0, "simt": want[0]},
          f"the float32 {what}'s K2 calls took {k2_variants}, expected "
          f"all on the SIMT variant")
    check(k3_variants == {"tensor_core": 0, "simt": want[1]},
          f"the float32 {what}'s K3 calls took {k3_variants}, expected "
          f"all {want[1]} on the SIMT variant")
    check(torch.allclose(got, want_logits, rtol=1e-3, atol=1e-3),
          f"{what}: card differs from CPU (max abs err {err})")
    out = {"card": card, "config": f"{arch}, n_layers {n_layers}, float32",
           "B": 1, "T": 256, "k2_launches": launches[0],
           "k2_launches_by_variant": k2_variants,
           "k3_launches": launches[1],
           "k3_launches_by_variant": k3_variants, "max_abs_err": err,
           "logit_scale": float(want_logits.abs().max()),
           "tolerance": "rtol = atol = 1e-3", "setup_s": setup_s,
           "card_s_first_call": card_s, "cpu_s": cpu_s}
    emit(phase, **out)
    return out


def phase_prefill(card: str, arch: str = "zamba2-7b", k2_want: int = 14,
                  k3_want: dict[str, int] | None = None,
                  phase: str = "zamba2_prefill") -> dict:
    """``arch`` at full width and depth, bf16 compute over float32
    parameters: one warm-up, three timed prefills (the first counted: K2
    launched ``k2_want`` times, all on its tensor-core variant, and K3 by
    variant ``k3_want``, by default 81 all on the tensor cores), and a
    profiled one, which must record the same launches, and no K3 time on
    a variant that ``k3_want`` expects none of."""
    if k3_want is None:
        k3_want = {"tensor_core": 81, "simt": 0}
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.models import build_model, param_count, prefill
    cfg = get_config(arch)
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
            k2_variants = k2.launch_counts()
            k3_variants = k3.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(tuple(logits.shape) == (PREFILL_B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{arch} prefill logits not finite or of the wrong shape")
    check(k2_variants == {"tensor_core": k2_want, "simt": 0},
          f"{arch} prefill's K2 launches by variant {k2_variants}, "
          f"expected all {k2_want} on the tensor-core variant")
    check(k3_variants == k3_want, f"{arch} prefill's K3 launches by "
                                  f"variant {k3_variants}, expected "
                                  f"{k3_want}")

    def run():
        prefill(model, batch)
        torch.cuda.synchronize()

    def missing(rows):
        k2_seen = matching(rows, K2_KERNEL)[1]
        k3_seen = {v: matching(rows, pat) for v, pat in K3_KERNELS.items()}
        if k2_seen == k2_want \
                and {v: n for v, (_, n) in k3_seen.items()} == k3_want \
                and all((ms > 0) == (k3_want[v] > 0)
                        for v, (ms, _) in k3_seen.items()):
            return None
        return (f"{k2_seen} K2 launches and K3's (ms, launches) by variant "
                f"{k3_seen}; the run made {k2_want} and {k3_want}")
    rows, prof_wall = profiled(run, missing, f"the {arch} prefill")
    busy = sum(ms for ms, _ in rows.values())
    k2_ms = matching(rows, K2_KERNEL)[0]
    k3_ms = sum(matching(rows, pat)[0] for pat in K3_KERNELS.values())
    top = sorted(((k, ms) for k, (ms, _) in rows.items()),
                 key=lambda kv: -kv[1])[:10]
    median = sorted(seconds)[1]
    out = {"card": card,
           "config": f"{arch}, {cfg.n_layers} layers, full width",
           "params": n_params, "param_count_analytic": param_count(cfg),
           "dtype": "bfloat16 compute, float32 parameters",
           "B": PREFILL_B, "T": PREFILL_T,
           "reduced": {"global_batch": f"{spec.global_batch} -> {PREFILL_B}",
                       "seq_len": f"{spec.seq_len} -> {PREFILL_T}",
                       "why": "the run's time limit and the simple kernels"},
           "init_s": init_s, "seconds": seconds, "median_s": median,
           "tokens_per_s": PREFILL_B * PREFILL_T / median,
           "peak_mem_bytes": peak, "k2_launches": k2_want,
           "k2_launches_by_variant": k2_variants,
           "k3_launches": sum(k3_want.values()),
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
    emit(phase, **out)
    return out


def kernel_entry(name: str, source: str, replaces: str, launches: int,
                 phase: dict) -> dict:
    """One kernel of the table line; ``variant`` names the one the main
    path ran where the kernel has more than one; ``ms`` and
    ``device_ms`` as :func:`time_cuda` and :func:`device_ms` take them."""
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
    built_b = build_cluster_b()
    k1 = phase_k1(card, built_b[0], env)
    phase_small()
    full = phase_full(card, built=built_b)
    phase_full(card, scale=2)
    phase_no_sync()
    k2 = phase_k2(card)
    k3 = phase_k3(card)
    phase_lm_parity(card)
    pre = phase_prefill(card)
    phase_lm_parity(card, "mamba2-2.7b", 4, (0, 4), "mamba2_parity")
    pre_m = phase_prefill(card, "mamba2-2.7b", 0,
                          {"tensor_core": 64, "simt": 0}, "mamba2_prefill")
    # the entry's launches and times are the tensor-core variant's at the
    # zamba2 prefill (N 64); its N 128 instantiation's at mamba2's shape
    # and the SIMT variant's there (float32, off both prefills) stand
    # beside them
    k3_entry = kernel_entry("ssd_scan", "ssd_scan.cu",
                            "src/repro/kernels/ssd_scan.py:66",
                            pre["k3_launches"], k3)
    at_mamba2 = k3["mamba2_shape"]
    timing = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
    tc_m, simt = at_mamba2["tensor_core"], at_mamba2["simt_float32"]
    k3_entry.update(
        launches_by_path={"zamba2-7b prefill": pre["k3_launches_by_variant"],
                          "mamba2-2.7b prefill":
                              pre_m["k3_launches_by_variant"]},
        tc_at_mamba2_shape={
            "launches": pre_m["k3_launches_by_variant"]["tensor_core"],
            "max_abs_err": tc_m["errors"]["tc_max_abs_err"],
            "library_ms": None} | {k: tc_m[k] for k in timing},
        simt_at_mamba2_shape={
            "launches": pre_m["k3_launches_by_variant"]["simt"],
            "dtype": "float32",
            "max_abs_err": simt["errors"]["max_abs_err"],
            "library_ms": None} | {k: simt[k] for k in timing})
    # K1's entry is the fused kernel the planner launches; the standalone
    # reduction, which no main path launches, stands beside it
    k1_entry = kernel_entry("select_rows", "masked_select.cu",
                            "src/repro/kernels/select_move.py:44",
                            full["k1_launches"], k1)
    alone = k1["standalone"]
    k1_entry.update(
        launches_by_kernel={"select_rows": full["k1_launches"],
                            "masked_select": 0},
        standalone_masked_select={"launches": 0} | {k: alone[k] for k in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms")})
    emit("profiles", sessions=PROFILE_LOG)
    print(json.dumps({"kernels": [
        k1_entry,
        kernel_entry("flash_attention", "flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:87",
                     pre["k2_launches"], k2),
        k3_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
