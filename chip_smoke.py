#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Builds every CUDA kernel of the port (K1, K2, K3) from
``src/repro_torch/csrc`` into ``build/repro_torch/``, then runs these
phases, one JSON line each, and exits non-zero if any fails:

0. environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions, the kernel build time; K1's fused kernel
   ``select_rows_kernel`` keeps float64 rounding in each of its six
   instantiations (staged or not, cached or not, and the two uncached
   ones with the fleet's lane axis): its PTX (``nvcc -ptx``)
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
   ``torch.cuda.set_sync_debug_mode("error")``; then ``cluster_b_warm``,
   the warm path on a copy of cluster B: one planner (chunk 64) through
   a first plan of 100 moves (a 28-move stash), pool growth with the
   stash held, a device out and a drain, the device back in, a device
   add, a foreign move, a pool create (64 PGs of the first pool's rule)
   and a device class that renumbers the carry's ids, each followed by a
   warm plan of 128 moves, then a plan to convergence; each warm call
   equals a cold plan on the card of an exact copy of the state (moves,
   ``sources_tried``); 2 rebuilds and 6 absorptions over the lifecycle,
   each absorption on the path (structural or not) its delta calls for,
   the foreign move's certificates kept, host syncs = chunks + re-pads +
   non-structural absorptions, K1's ``select_rows`` once a step; the
   absorb and rebuild seconds beside the cold plans' set-up seconds;
   then ``dense_lanes``: the per-source legacy lane
   (``equilibrium_jax_legacy``, one upload, one launch of K1's standalone
   reduction ``masked_select`` and one fetch a source) on the card and
   the host dense lane (``equilibrium``, with and without source bounds)
   on four small clusters, at the default config and the fuzzer's slack
   regression's (``count_slack`` 1.39, ``min_variance_delta`` 1e-5),
   each equal to the faithful planner (moves, ``sources_tried``, the
   certificate counters); then both lanes to convergence on exact copies
   of cluster B: phase 3's 839 moves, the ``tried_hist`` of
   ``planner.tail.B1x.batch-nobounds``, the legacy lane's
   ``masked_select`` launched once per evaluated source (one host sync
   each) and ``select_rows`` never, its first 50 launches bitwise against
   the plain version on the same masks; seconds, moves/s and launches of
   each lane, and the standalone kernel's times at the lane's mask shape;
   where the legacy lane's time goes over its first 100 moves (host
   seconds by part, and a profile: device busy time, idle share, device
   operations and K1's device time a source); then the simulator
   (``repro_torch.core.simulate``, ``repro_torch.sim``):
   ``cluster_b_replay``, phase 3's plan replayed through ``simulate`` and
   ``simulate_throttled`` (the paper's Table-1 quantities: gained free
   space, moved bytes, variance before and after, the throttled ticks),
   the throttled replay ending with an empty backlog, its ledger
   balanced every tick and its physical bytes those of the target map
   (rtol 1e-12); ``cluster_b_lifecycle``, one ``ScenarioEngine`` at
   cluster B with the warm ``equilibrium_batch`` on the card (24 ticks,
   64 moves a tick: growth of pools 0 and 2, a drain, a 12-OSD host, a
   failure, a 256-PG EC 8+3 pool and its growth, 32 foreign upmaps, an
   SSD), its metrics JSON and every tick's planned moves equal to the
   host ``equilibrium`` lane's on another exact copy, one rebuild, K1's
   ``select_rows`` once a step and ``masked_select`` never, host syncs =
   chunks + re-pads + non-structural absorbs, the throttle's ledger
   balanced every tick, both states valid; each tick's host seconds
   split into the plan's chunks, its absorb and the engine's own work,
   and both lanes' seconds; ``scenarios``, the six scenarios at full
   length with ``equilibrium_batch`` on the card, each run's metrics
   byte for byte those of ``BENCH_scenarios.json``, one rebuild each,
   ``select_rows`` once a step; then ``fuzz``, the differential fuzzer
   (``repro_torch.fuzz``) on the card: ``generate_timeline`` seeds 0 to
   31 of the ``quick`` profile and 0 to 7 of ``nightly`` and the four
   ``tests/regressions`` timelines, each through the port's whole
   ``"equilibrium"`` class with the device at its default (the batch and
   legacy lanes on the card), the ``mgr`` and ``none`` baselines and the
   serialize-and-replay check, every oracle a gate (legality and
   variance replayed on a pre-plan copy, the throttle's ledger every
   tick, agreement of move streams and metrics JSON, one rebuild of the
   batch, the fleet and the sharded lane, replay; the fleet lane is a
   fleet of one on the card, the sharded lane one shard with no process
   group); K1's ``select_rows`` once a step of the batch lanes and once a
   step of the fleet lanes (counted apart), its window form once a step
   of the sharded lanes and ``masked_select`` once per source the legacy
   lanes evaluated, each more than zero times; the fleet and sharded
   lanes' seconds; oracle checks by oracle,
   timelines, lanes, moves and seconds; then the cluster-B lifecycle of
   ``cluster_b_lifecycle`` through the warm batch lane on the card
   behind the harness's replay proxy, its 24 ticks' moves replayed
   through ``move_is_legal`` and ``apply``, the variance never rising,
   its moves, metrics JSON, rebuild and ``select_rows`` launches those
   of ``cluster_b_lifecycle``;
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
11. ``batch_optins`` (after the prefills, so that every earlier phase
    runs as it did before), the batch engine's opt-ins: K1's cached
    instantiation (the legality cache) bitwise against its plain version
    (``any``, ``dst``, ``cand_src``, ``cand_row`` and the cache it
    writes) on the test carries in each cache state (every block a miss,
    every block a hit, a tag mismatch), on the engine's own cache after
    planning steps with it, and at cluster B's first step, staged and
    from device memory, with its times there beside the uncached
    instantiation's; the cache x pipeline x source bounds matrix at chunk
    8 on two small clusters, the card's run equal to the CPU's in moves
    and every counter; cluster B with the cache to convergence on an
    exact copy under a tracer, its moves, histogram and certificate
    counters those of ``planner.tail.B1x.batch-cache``, its tiles walked,
    candidate tiles, cache hits, misses and repairs and pipelined chunks
    those the reference engine recorded in
    ``tests/fixtures/batch_counters_cluster_b.json``, ``select_rows`` once
    a step and every launch cached; plan seconds with the cache on and
    the pipeline off beside the defaults, one untraced run each; a profiled
    first chunk with the cache; and the ``quick`` part of phase ``fuzz``'s
    sweep through the batch lane with the cache under a tracer, every
    oracle a gate, against that phase's faithful and dense lanes;
12. ``source_block`` (after ``batch_optins``): the walk's source block
    above 1, on exact copies of phase 3's cluster B to convergence at
    source block 3 (nine blocks, the last padded to 27 positions) and 25
    (one block), each with the legality cache on and off under a tracer:
    839 moves, ``planner.tail.B1x.batch``'s histogram and certificate
    counters, the tiles walked, candidate tiles, cache hits, misses and
    repairs, pipelined chunks, re-pads and stash moves the reference
    engine recorded at that block in
    ``tests/fixtures/batch_counters_cluster_b.json``, one host sync a
    chunk, ``select_rows`` once a step (every launch cached with the
    cache) and ``masked_select`` never; one chunk at each block with the
    cache and the telemetry under ``set_sync_debug_mode("error")``; plan
    seconds of each run and of the default (source block 1, no cache),
    one untraced run each;
13. ``fleet`` (after ``source_block``): the fleet planner
    (``repro_torch.fleet``) and K1 with a lane axis.  K1's lane launch
    bitwise against the lane form of its plain version, staged and from
    device memory, at the first step of the cluster-B fleet and of each
    bucket of the paper fleet (padded devices, per-lane ``n_f``); its
    times at the 8-lane shape, its bound counted from each lane's carry,
    and the one-carry launch's times at lane 0 beside them.  The
    cluster-B fleet: 8 exact copies of cluster B, lane i's pool 0 grown
    by i x 10 TiB first, pinned to one bucket (row capacity 256),
    ``FleetPlanner(chunk=64, row_block=8)`` to convergence: every lane's
    moves and certificate counters equal to a serial ``BatchPlanner``
    configured like a lane on an exact copy, lane 0 to
    ``planner.tail.B1x.batch`` and phase 3's plan, one round fetch a
    round, ``select_rows`` once a bucket step, no host sync in a fleet
    chunk (``set_sync_debug_mode("error")``); the fleet step's PyTorch
    operations untraced and traced (``tools/step_op_count.py``'s
    ``OpCount``); a profiled fleet chunk.  Then the 8 serial plans, and
    the fleet again with its first tick cut by an SLO of 0.0 s: every
    lane's partial plan legal on replay and ``slo_expired``, its
    continuation to convergence the uncut stream; the fleet's seconds
    (set-up and plan) before and after the serial plans'.  The paper fleet
    (clusters A to F, B phase 3's) in co-scheduled rounds to convergence,
    each lane equal to its serial planner (cluster B to phase 3's plan);
14. ``shard`` (after ``fleet``): the sharded batch engine
    (``repro_torch.core.shard``) in an NCCL process group of one rank,
    made in this process with a ``file://`` store.  K1's window form
    (``select_rows_window_kernel``, both instantiations) bitwise against
    ``select_rows_window_ref`` at cluster B's first step on every window
    of the device axis split 1, 2 and 4 ways, staged and from device
    memory, each split's windows folded as the engine folds its ranks
    equal to one unwindowed ``select_rows`` launch, the whole axis's
    window timed with its bound counted from the data; cluster B planned
    by ``equilibrium_batch_sharded`` to convergence: phase 3's 839 moves,
    variances, sources tried, certificate counters and ``batch.*``
    counters, one window launch a step (896), no unwindowed
    ``select_rows``, one host sync a chunk; one sharded chunk under
    ``set_sync_debug_mode("error")``; the PyTorch operations and
    collectives a step (``tools/step_op_count.py``'s ``count`` on the
    card); a profiled sharded chunk; the serial plan's seconds right
    after the sharded plan's;
15. ``serve`` (after ``shard``), the serving path
    (``repro_torch.models.decode_step``, ``init_cache``,
    ``repro_torch.serve.ServeEngine``), which launches no K1, K2 or K3:
    (a) ``decode_step`` at full width in float32 (TF32 off) on the card
    against the same parameters on the CPU, 16 steps from an empty cache
    at B 2, every step's logits within rtol = atol = 1e-3, for zamba2-7b
    cut to 6 layers (one shared-block application), mamba2-2.7b cut to
    4 and qwen3-0.6b cut to 2; (b) on that 6-layer zamba2, 64
    teacher-forced decode steps against ``prefill`` of the same 64
    tokens on the card (K2 and K3 launched 1 and 6 times, SIMT), the
    last-token logits within :data:`DECODE_PREFILL_TOL`; (c) a
    ``ServeEngine`` on zamba2-7b at full width and depth (81 layers, bf16
    compute over float32 parameters), 4 slots, ``max_len`` 256, a
    ``PagedKVPool`` of 4 chips with 16-token pages, 8 requests of 8 to 24
    prompt tokens (NumPy seed 0) and 32 new tokens each, a rebalance every
    :data:`SERVE_REBALANCE_EVERY` steps: every request finishes with 32
    tokens, every decode call's logits are finite, the cache's ``len``
    stays below ``max_len``, at least two rebalances see live sequences
    (each plan's moves printed, and why none moved where none did);
    steps, tokens, decode-step milliseconds (median and spread of the
    steps that admitted nothing), tokens/s, peak memory, migrated bytes,
    the pool's final utilization, the PyTorch operations of one decode
    step (``tools/step_op_count.py``'s ``OpCount``) and a profiled decode
    step (device operations, busy ms, idle share, top ten kernels);
16. ``train`` (the last, after ``serve``), the training path
    (``repro_torch.models.loss_fn``, ``repro_torch.train``,
    ``repro_torch.checkpoint``, ``python -m repro_torch.launch.train``),
    with K2 and K3 differentiable (``kernels/ops.py::FlashAttention``,
    ``SSDScan``: the kernels' forwards, plain backwards): (a) K2's
    log-sum-exp (``with_lse``) against the plain online version's on
    float32 copies of bf16 inputs, at the zamba2 shape (the tensor-core
    variant) and at Dh 160 (the SIMT variant), causal and with a window
    and a softcap, within 2e-3, the output unchanged beside it; (b) the
    backward passes at a qwen3 layer's attention and a mamba2 layer's
    scan (T 4,096, bf16) through the kernels' forwards against the
    all-plain path on the card: attention within 2e-2 of each gradient's
    largest entry, the scan's forward within ``ROW_REL_TOL`` of the float32
    plain version in every row and its gradients equal (the backward's
    plain recompute); (c) one ``make_train_step``
    step at full width in float32 (TF32 off) on the card and on the CPU
    from one set of parameters, zamba2-7b cut to 6 layers, mamba2-2.7b to
    4, qwen3-0.6b to 2 (B 1, S 128): the loss and the gradients (as the
    step's ``mu``) within 1e-3; (d) qwen3-0.6b at full width and depth
    through the launcher in this process (``--full``, B 4, S 4,096,
    :data:`TRAIN_QWEN3_STEPS` steps saving every :data:`TRAIN_SAVE_EVERY`
    under ``build/train_ckpt``), then a second invocation resuming from
    the first save to the same end: the first loss within 0.5 of ln V,
    every loss and grad norm finite, 56 K2 launches a step (forward and
    remat recompute), all tensor core, the restored tensors bitwise those
    the first run held at the save, the resumed losses within
    :data:`TRAIN_RESUME_TOL`; (e) mamba2-2.7b at full width and depth
    (B 1, S 4,096, 3 steps): finite, 128 K3 launches a step, all tensor
    core; for (d) and (e) per-step seconds, the median of the steps that
    followed no save, tokens/s, peak memory and a profiled further step
    (device ms, idle share, top kernels, the kernel's share and the
    share of the kernels launched inside the plain backwards' autograd
    nodes);
17. the kernel table line (K1 twice: ``select_rows``'s uncached and,
    as ``select_rows_cached``, its cached instantiation's launches and
    times; the uncached one's launches by path (the cold cluster-B plan, the warm
    lifecycle, the legacy lane's standalone reduction, the simulator's
    cluster-B lifecycle, the six scenarios, the fuzz sweep and corpus by
    kernel, the fleet lanes of the fuzz sweep and corpus, the cluster-B
    lifecycle under the fuzzer's oracles, phase ``source_block``'s runs,
    phase ``fleet``'s two fleets, and the window form's on phase
    ``shard``'s plan and the fuzzer's sharded lane) and its 8-lane
    launch's times and the window form's, and the standalone
    reduction's launches and times at the legacy lane's shape beside
    them, with its times at the batch step's shape; K3 once: the
    tensor-core variant's launches and times at the zamba2 prefill, and
    beside them its N 128 instantiation's and the SIMT variant's at
    mamba2's shape); the last line names the device.

Kernel times come in two forms: ``ms``, CUDA events around calls the
host issues back to back, and ``device_ms``, CUDA events around calls
queued behind a sleep kernel, which the host's issue rate cannot set.
The prefills' profiles must hold every K2 and K3 launch the run counted,
and phase ``fleet``'s every K1 launch of its chunk.  On the H100 a
profiler session loses the kernel records of its first launches, more of
them the more sessions the process has had (``tools/profile_records.py``):
so every session opens with :data:`LEAD_IN` launches of the sleep kernel,
which take that loss and are left out of every count (the records of
them lost go to the profile log).  A session that still lost a launch of
the run is run again, three sessions at most; the sessions each profile
took are printed before the kernel table line.

``--plan-only`` runs phases 0 and 3 (scale 1) alone and prints no result
line: the way to time two trees in turns within one run on one card.
The whole run builds ``cluster_b(scale=2)`` (host NumPy, tens of
seconds) in a process of its own (``--build-cluster-b2``) while phases 0
to 3 run, and stops it if a phase fails first.

It imports only ``repro_torch``, the tests' planner carries
(``tests/_select_rows_carries.py``, which import only ``repro_torch``),
``tools/step_op_count.py`` (which imports only ``repro_torch``), torch,
NumPy and the standard library.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from collections import Counter
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
#: sleep-kernel launches that open every profile session
#: (:func:`profile_session`): a session loses the records of its first
#: launches (tens after many sessions in one process), and these take
#: that loss instead of the run's
LEAD_IN = 4096
#: the sleep kernel as the profiler names it (at::cuda::sleep's)
LEAD_IN_KERNEL = "spin_kernel"

#: K1's fused kernel as the profiler names it
K1_KERNEL = "select_rows_kernel"
#: the committed reference records of cluster B's full convergence, by
#: scale
BENCH_ROWS = {1: "planner.tail.B1x.batch", 2: "planner.tail.B2x.batch"}


#: when this module was imported: each phase line's ``at_s`` counts from it
STARTED = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - STARTED}), flush=True)


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
    profile: its device records summed by name, as ``key_averages()``
    sums them, read from the raw trace (``key_averages()`` builds every
    host event's tree first: seconds a session of 20,000 launches)."""
    rows: dict[str, tuple[float, int]] = {}
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()) != "DeviceType.CUDA":
            continue                    # host-side records; kernels below
        ms, n = rows.get(ev.name(), (0.0, 0))
        rows[ev.name()] = (ms + ev.duration_ns() / 1e6, n + 1)
    return rows


def profile_session(run) -> tuple[dict[str, tuple[float, int]], float,
                                  int]:
    """One profiler session of ``run()`` (which ends in a synchronize),
    opened by :data:`LEAD_IN` sleep-kernel launches: the run's
    :func:`kernel_rows`, its wall seconds and the lead-in records the
    session lost."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    rows = kernel_rows(prof)
    lead = sum(n for k, (_, n) in rows.items() if LEAD_IN_KERNEL in k)
    return ({k: v for k, v in rows.items() if LEAD_IN_KERNEL not in k},
            wall, LEAD_IN - lead)


def matching(rows: dict[str, tuple[float, int]], pattern: str
             ) -> tuple[float, int]:
    """Milliseconds and launches of the rows whose name holds
    ``pattern``."""
    hits = [v for k, v in rows.items() if pattern in k]
    return sum(ms for ms, _ in hits), sum(n for _, n in hits)


def profiled(run, missing, what: str
             ) -> tuple[dict[str, tuple[float, int]], float]:
    """:func:`kernel_rows` of a profile of ``run()`` (which ends in a
    synchronize) and its wall seconds (:func:`profile_session`).
    ``missing(rows)`` holds the launches the profile recorded to the
    launches ``run()`` made and says what is missing, or returns None.
    A session that misses any launch is run again, up to
    :data:`PROFILE_TRIES` sessions in all, and the run fails if none
    holds every launch.  No number comes from a session that lost
    records.  Each profile's sessions, and the lead-in records each
    session lost, go to :data:`PROFILE_LOG`."""
    lost = []
    for n in range(1, PROFILE_TRIES + 1):
        rows, wall, lead_lost = profile_session(run)
        lost.append(lead_lost)
        gap = missing(rows)
        if gap is None:
            PROFILE_LOG.append({"profile": what, "sessions": n,
                                "lead_in_records_lost": lost})
            return rows, wall
        print(f"chip_smoke: profile session {n} of {what} lost launch "
              f"records: {gap} (and {lead_lost} of its {LEAD_IN} lead-in "
              f"records)", file=sys.stderr, flush=True)
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
    """``select_rows_kernel`` and its window form
    ``select_rows_window_kernel`` keep the plain version's float64
    rounding:
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
        # select_rows_kernel<kStaged, kCached, kLanes> and the window
        # form's select_rows_window_kernel<kStaged>
        if m := re.search(r"select_rows_kernelILb([01])ELb([01])ELb([01])E",
                          name):
            key = ("staged" if m.group(1) == "1" else "device_memory") \
                + ("_cached" if m.group(2) == "1" else "") \
                + ("_lanes" if m.group(3) == "1" else "")
        elif m := re.search(r"select_rows_window_kernelILb([01])E", name):
            key = "window_" + ("staged" if m.group(1) == "1"
                               else "device_memory")
        else:
            continue
        ops = [(m.group(1), m.group(2)) for m in PTX_F64_OP.finditer(body)]
        unrounded = sum(op in ("add", "sub", "mul") and ".rn" not in mods
                        for op, mods in ops)
        fma = sum(op == "fma" for op, _ in ops)
        div = sum(op == "div" and ".rn" in mods for op, mods in ops)
        dfma = division_only_dfma(sass[name])
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
    check(set(out) == {"staged", "device_memory", "staged_cached",
                       "device_memory_cached", "staged_lanes",
                       "device_memory_lanes", "window_staged",
                       "window_device_memory"},
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

    # times at the batch step's shape: 25 sources x 184 rows, 995 OSDs
    M, D = 25 * 184, 995
    v = torch.as_tensor(rng.random((M, D)) < 0.05, device=dev)
    u = torch.as_tensor(rng.random(D), dtype=torch.float64, device=dev)
    out = {"cases": len(cases), "max_abs_err": worst,
           **time_masked_select(v, u)}
    emit("k1_masked_select", **out)
    return out


def time_masked_select(v: torch.Tensor, u: torch.Tensor) -> dict:
    """K1's standalone reduction on the mask ``v`` and util ``u`` (on the
    card): kernel, plain, library-call and bound times."""
    from repro_torch.kernels.ref import masked_select_ref
    from repro_torch.kernels.select_move import masked_select_fwd
    M, D = v.shape
    inf = torch.tensor(float("inf"), dtype=u.dtype, device=u.device)
    # least work: read the mask and util once, write any and dst once;
    # one comparison per mask entry
    nbytes = M * D * v.element_size() + D * u.element_size() + M * (1 + 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = M * D / VECTOR_OPS_PER_S * 1e3
    return {"shape": [M, D], "dtype": str(u.dtype).split(".")[-1],
            "ms": time_cuda(lambda: masked_select_fwd(v, u)),
            "plain_ms": time_cuda(lambda: masked_select_ref(v, u)),
            "library_ms": time_cuda(
                lambda: torch.where(v, u, inf).min(dim=1)),
            "device_ms": device_ms(lambda: masked_select_fwd(v, u), 50),
            "library_device_ms": device_ms(
                lambda: torch.where(v, u, inf).min(dim=1), 50),
            "bytes": nbytes, "ops": M * D,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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


def profile_chunk(state, card: str, engine=None, kernel: str = K1_KERNEL,
                  **options) -> dict:
    """Kernel time by name over the first chunk of a fresh cluster-B plan
    (profiler on, :func:`profile_session`; its timings are read for
    shares, not reported as the plan's speed); ``engine``: the planner
    class (default ``BatchPlanner``), ``options`` its options; ``kernel``
    names K1's kernel in the profile."""
    from repro_torch.core.equilibrium_batch import BatchPlanner
    planner = (engine or BatchPlanner)(state, device="cuda", **options)
    planner.sync()
    out = []

    def run():
        out.append(planner._step.run(planner.chunk))
        torch.cuda.synchronize()

    by_name, wall, lead_lost = profile_session(run)
    moves = int((out[0][:5 * planner.chunk].view(-1, 5)[:, 0] >= 0).sum())
    rows = sorted(((ms, key, n) for key, (ms, n) in by_name.items()),
                  reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e3
    ops = sum(r[2] for r in rows)
    k1 = [(ms, n) for ms, key, n in rows if kernel in key]
    return {"card": card, "chunk_steps": planner.chunk, "moves": moves,
            "wall_s": wall, "device_busy_s": busy_s if rows else None,
            "idle_share": (1.0 - busy_s / wall) if rows else None,
            "device_ops": ops, "device_ops_per_step": ops / planner.chunk,
            "k1_device_ms": sum(ms for ms, _ in k1),
            "k1_calls_recorded": sum(n for _, n in k1),
            "lead_in_records_lost": lead_lost,
            "top": [{"name": k[:80], "device_ms": ms, "calls": n}
                    for ms, k, n in rows[:12]]}


def build_cluster_b(scale: int = 1) -> tuple:
    """``cluster_b(scale)`` and the host seconds its build took."""
    from repro_torch.core.clustergen import cluster_b
    t0 = time.perf_counter()
    base = cluster_b(scale=scale)
    return base, time.perf_counter() - t0


#: where a process of its own leaves ``cluster_b(scale=2)`` as a pickled
#: plain dict (a directory that ``.gitignore`` lists)
CLUSTER_B2 = ROOT / "build" / "chip_smoke_cluster_b2.pkl"


def start_cluster_b2() -> subprocess.Popen:
    """Start building ``cluster_b(scale=2)`` (host NumPy, tens of
    seconds) in a process of its own, beside the phases before it."""
    CLUSTER_B2.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, __file__, "--build-cluster-b2", str(CLUSTER_B2)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def build_cluster_b2_alone(path: str) -> int:
    """``--build-cluster-b2``: pickle ``cluster_b(scale=2).to_plain()`` to
    ``path``; prints the build's seconds."""
    import pickle
    base, secs = build_cluster_b(2)
    Path(path).write_bytes(pickle.dumps(base.to_plain()))
    print(json.dumps({"cluster_build_s": secs}), flush=True)
    return 0


def built_cluster_b2(proc: subprocess.Popen) -> tuple:
    """The cluster :func:`start_cluster_b2` built (an exact copy: the
    bytes as built) and the seconds its build took."""
    import pickle
    from repro_torch.core import ClusterState
    out, err = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"cluster_b(scale=2)'s build failed: "
                                f"{err[-2000:]}")
    secs = json.loads(out.strip().splitlines()[-1])["cluster_build_s"]
    base = ClusterState.from_plain(pickle.loads(CLUSTER_B2.read_bytes()))
    CLUSTER_B2.unlink()
    return base, secs


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
    check(launches == {"select_rows": steps, "masked_select": 0,
                       "select_rows_window": 0},
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
    out["move_list"] = as_tuples(res.moves)       # phase dense_lanes' gate
    # phase shard's
    out["variance_trajectory"] = [r.variance_after for r in res.records]
    out["sources_tried"] = [r.sources_tried for r in res.records]
    out["batch_counters"] = {k: int(v) for k, v in d.items()
                             if k.startswith("batch.")}
    out["stats"] = {k: st[k] for k in FLEET_STAT_KEYS}   # phase fleet's
    out["moves"] = res.moves                      # phase cluster_b_replay's
    prof = profile_chunk(base.copy(), card)
    emit("cluster_b_profile", **prof)
    out["profile"] = prof
    return out


# ---------------------------------------------------------------------------
# phase 4


def chunk_without_sync(state, telemetry: bool = False, **options
                       ) -> tuple[int, int]:
    """One chunk of ``BatchPlanner(state, **options)`` on the card under
    ``torch.cuda.set_sync_debug_mode("error")``, so that a host sync
    inside it raises: (the chunk's length, the moves it emitted)."""
    from repro_torch.core.equilibrium_batch import BatchPlanner
    planner = BatchPlanner(state, device="cuda", **options)
    planner.sync()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = planner._step.run(planner.chunk, telemetry=telemetry)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return (planner.chunk,
            int((out[:5 * planner.chunk].view(-1, 5)[:, 0] >= 0).sum()))


def phase_no_sync() -> dict:
    from repro_torch.core.clustergen import cluster_a
    chunk, moves = chunk_without_sync(cluster_a())
    check(moves > 0, "cluster A chunk emitted no move")
    res = {"chunk": chunk, "moves": moves, "syncs_in_chunk": 0}
    emit("no_sync", **res)
    return res


# ---------------------------------------------------------------------------
# phase 4b: the warm path (warm start and delta absorption) at cluster B


def exact_copy(state):
    """A copy with the per-device bytes as they are (``copy()`` re-sums
    them, which can differ in the last bit after moves and growth)."""
    from repro_torch.core import ClusterState
    return ClusterState.from_plain(state.to_plain())


def traced_plan(planner, state, budget) -> tuple:
    """One plan call under the tracer: (result, its registry deltas, its
    trace records, wall seconds, the chunks' seconds, the seconds from the
    plan's start to its first chunk: the absorb or the rebuild)."""
    from repro_torch import obs
    reg = obs.registry()
    snap = reg.snapshot()
    with obs.tracing() as tr:
        t0 = time.perf_counter()
        res = planner.plan(state, budget=budget, record_trajectory=True,
                           record_free_space=False)
        wall = time.perf_counter() - t0
    recs = tr.records
    d = reg.deltas_since(snap)
    spans = [r for r in recs if r.get("ev") == "span"]
    chunks = [r for r in spans if r["name"] == "batch.chunk"]
    start = next(r["ts"] for r in spans if r["name"] == "planner.plan")
    sync_s = ((min(r["ts"] for r in chunks) - start) / 1e6 if chunks
              else None)
    return (res, d, recs, wall, sum(r["dur"] for r in chunks) / 1e6,
            sync_s)


def drain(state, osd: int) -> int:
    """Move each shard of ``osd``, in sorted (pg, slot) order, to the first
    device that ``move_is_legal`` allows; returns the moves made."""
    from repro_torch.core import Movement
    n = 0
    for pg, slot in sorted(state.shards_on[osd]):
        for dst in state.devices:
            if state.move_is_legal(pg, slot, dst.id):
                state.apply(Movement(pg, slot, osd, dst.id,
                                     state.shard_sizes[pg]))
                n += 1
                break
    return n


def phase_warm(card: str, base) -> dict:
    """One planner on a copy of cluster B through nine steps: a first
    plan that leaves a stash, then pool growth, a device out and a drain,
    the device back in, a device add, a foreign move, a pool create and a
    class that renumbers the carry's ids, each followed by a warm plan of
    two whole chunks, and a last plan to convergence.  Each warm call is
    held to a cold plan on the card of an exact copy of the state taken
    just before it."""
    from repro_torch.core import Device, Movement, Pool, place_pg
    from repro_torch.core.equilibrium import EquilibriumConfig
    from repro_torch.core.planner import create_planner
    from repro_torch.kernels import select_move
    state = base.copy()
    chunk, first_budget = 64, 100
    planner = create_planner("equilibrium_batch", device="cuda",
                             chunk=chunk)
    whole = 2 * chunk                   # two whole chunks: no stash left
    largest = max(state.pools.values(), key=lambda p: p.stored_bytes)
    first = state.pools[min(state.pools)]
    util = state.utilization()
    out_osd = state.devices[int(np.argmax(util))].id
    d0 = state.devices[0]
    info: dict = {}

    def grow(s):
        s.grow_pool(largest.id, 0.02 * largest.stored_bytes)

    def out(s):
        s.mark_out(out_osd)
        info["drained"] = drain(s, out_osd)

    def back_in(s):
        s.mark_out(out_osd, out=False)

    def add(cls, host):
        def fn(s):
            s.add_device(Device(id=1 + max(d.id for d in s.devices),
                                capacity=d0.capacity, device_class=cls,
                                host=host, rack=d0.rack,
                                datacenter=d0.datacenter))
        return fn

    def foreign(s):
        moves = create_planner("equilibrium_faithful",
                               cfg=EquilibriumConfig(max_moves=1)).plan(
            exact_copy(s)).moves
        check(len(moves) == 1, "foreign move: the faithful planner found "
              "no move")
        mv = moves[0]
        s.apply(Movement(mv.pg, mv.slot, mv.src_osd, mv.dst_osd, mv.size))
        info["foreign_move"] = [list(mv.pg), mv.slot, mv.src_osd,
                                mv.dst_osd]

    def create(s):
        pid = 1 + max(s.pools)
        pool = Pool(pid, "warm-created", 64, first.rule, ec_k=first.ec_k,
                    stored_bytes=first.stored_bytes * 64 / first.pg_count)
        s.add_pool(pool, {(pid, i): place_pg(s.devices, pool, i, seed=3)
                          for i in range(64)},
                   {(pid, i): pool.nominal_shard_size for i in range(64)})

    first_class = sorted({d.device_class for d in state.devices})[0]
    # (step, mutation, budget, the absorb path expected with no stash:
    # True structural, False not, None no absorb)
    steps = [("first_plan", None, first_budget, None),
             ("pool_growth", grow, whole, True),
             ("out_and_drain", out, whole, True),
             ("back_in", back_in, whole, False),
             ("device_add", add(d0.device_class, "warm-host-0"), whole,
              False),
             ("foreign_move", foreign, whole, True),
             ("pool_create", create, whole, True),
             ("renumbering_class", add("a" + first_class, "warm-host-1"),
              whole, None),
             ("to_convergence", None, None, None)]
    rows = []
    totals = {"rebuilds": 0, "absorb_runs": 0, "host_syncs": 0,
              "chunks": 0, "repads": 0, "non_structural": 0,
              "k1_launches": 0, "standalone_launches": 0}
    impl = None
    for name, mutate, budget, want_structural in steps:
        stash_before = len(impl._stash) if impl is not None else 0
        seen: list = []
        if mutate is not None:
            state.subscribe(seen.append)
            mutate(state)
            state.unsubscribe(seen.append)
        snapshot = exact_copy(state)
        select_move.reset_launch_count()
        res, d, recs, wall, chunks_s, sync_s = traced_plan(planner, state,
                                                           budget)
        launches = select_move.launch_counts()
        impl = planner._impl
        cold, _, _, cold_wall, cold_chunks_s, cold_sync_s = traced_plan(
            create_planner("equilibrium_batch", device="cuda", chunk=chunk),
            snapshot, budget)
        check(as_tuples(res.moves) == as_tuples(cold.moves)
              and [r.sources_tried for r in res.records]
              == [r.sources_tried for r in cold.records],
              f"warm step {name}: moves or sources_tried differ from a "
              f"cold plan of the same state")
        points = [r["args"] for r in recs
                  if r.get("name") == "batch.absorb"]
        n_chunks = int(d.get("batch.chunks", 0))
        repads = int(d.get("batch.repads", 0))
        absorbed = int(d.get("absorb.runs", 0))
        check(absorbed == len(points) <= 1,
              f"warm step {name}: {absorbed} absorb runs")
        point = points[0] if points else {}
        structural = point.get("structural")
        non_structural = int(structural is False)
        check(res.stats["host_syncs"] == n_chunks + repads + non_structural,
              f"warm step {name}: host syncs {res.stats['host_syncs']} != "
              f"chunks {n_chunks} + re-pads {repads} + "
              f"{non_structural} non-structural absorb")
        check(launches == {"select_rows": chunk * n_chunks,
                           "masked_select": 0,
                           "select_rows_window": 0},
              f"warm step {name}: K1 launched {launches} over {n_chunks} "
              f"chunks")
        if want_structural is not None:
            want = want_structural or stash_before > 0
            check(absorbed == 1 and res.stats["rebuilds"] == 0
                  and structural is want,
                  f"warm step {name}: absorbed {absorbed}, rebuilds "
                  f"{res.stats['rebuilds']}, structural {structural}, "
                  f"expected {want} (stash before: {stash_before})")
        else:
            want = None
            check(absorbed == 0 and res.stats["rebuilds"]
                  == (0 if name == "to_convergence" else 1),
                  f"warm step {name}: absorbed {absorbed}, rebuilds "
                  f"{res.stats['rebuilds']}")
        if name == "first_plan":
            check(len(impl._stash) == -(-budget // chunk) * chunk - budget,
                  f"first plan left {len(impl._stash)} stashed moves")
        if name == "pool_growth":
            check(stash_before > 0, "pool growth without a held stash")
        if name == "out_and_drain":
            check(info["drained"] > 0, "the drain moved nothing")
        if name == "foreign_move":
            check(point.get("kept_bounds") is True,
                  "foreign move: certificates not kept")
        totals["rebuilds"] += res.stats["rebuilds"]
        totals["absorb_runs"] += absorbed
        totals["host_syncs"] += res.stats["host_syncs"]
        totals["chunks"] += n_chunks
        totals["repads"] += repads
        totals["non_structural"] += non_structural
        totals["k1_launches"] += launches["select_rows"]
        totals["standalone_launches"] += launches["masked_select"]
        rows.append({
            "step": name, "budget": budget,
            "deltas": dict(sorted(Counter(type(x).__name__
                                          for x in seen).items())),
            "structural": structural, "expected_structural": want,
            "kept_bounds": point.get("kept_bounds"),
            "certificates_held": point.get("certificates_held"),
            "certificates_kept": point.get("certificates_kept"),
            "stash_before": stash_before, "stash_after": len(impl._stash),
            "rebuilds": res.stats["rebuilds"], "moves": len(res.moves),
            "chunks": n_chunks, "repads": repads,
            "host_syncs": res.stats["host_syncs"],
            "plan_s": wall, "chunks_s": chunks_s,
            "absorb_s": wall - chunks_s, "sync_s": sync_s,
            "cold_plan_s": cold_wall, "cold_chunks_s": cold_chunks_s,
            "cold_setup_s": cold_wall - cold_chunks_s,
            "cold_sync_s": cold_sync_s})
    check(totals["rebuilds"] == 2, f"{totals['rebuilds']} rebuilds over "
          f"the lifecycle, expected 2")
    check(totals["absorb_runs"] == 6, f"{totals['absorb_runs']} absorb "
          f"runs, expected 6")
    check(totals["host_syncs"] == totals["chunks"] + totals["repads"]
          + totals["non_structural"], "host syncs over the lifecycle")
    out = {"card": card, "chunk": chunk, "out_osd": out_osd, **info,
           **totals, "variance_before": base.utilization_variance(),
           "variance_after": state.utilization_variance(), "steps": rows}
    emit("cluster_b_warm", **out)
    return out


# ---------------------------------------------------------------------------
# phase 4c: the dense lanes (equilibrium and equilibrium_jax_legacy)

#: the fuzzer's slack regression config
#: (``tests/regressions/legacy-slack-divergence.json``)
SLACK_CFG = {"count_slack": 1.39, "min_variance_delta": 1e-5}
#: the cluster-B legacy launches whose (any, dst) are held bitwise to the
#: plain version on the same mask
LEGACY_HELD = 50


class ReductionSpy:
    """Wraps ``ops.masked_select`` (the dense legacy lane's reduction
    call) while active: counts the calls and keeps the first ``keep``
    calls' mask, util and outputs, cloned on the card, for a bitwise
    comparison after the run."""

    def __init__(self, keep: int = 0):
        self.keep, self.calls, self.held = keep, 0, []

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops, self._real = ops, ops.masked_select

        def spy(valid, util):
            any_row, dst = self._real(valid, util)
            self.calls += 1
            if len(self.held) < self.keep:
                self.held.append((valid.clone(), util.clone(),
                                  any_row.clone(), dst.clone()))
            return any_row, dst

        ops.masked_select = spy
        return self

    def __exit__(self, *exc):
        self._ops.masked_select = self._real


def dense_lane_plan(lane: str, state, cfg=None, keep: int = 0, **kw):
    """One plan of a dense lane under :class:`ReductionSpy`: (result,
    seconds, K1 launches by kernel, spy)."""
    from repro_torch.core.equilibrium import EquilibriumConfig
    from repro_torch.core.planner import create_planner
    from repro_torch.kernels import select_move
    planner = create_planner(lane, cfg=cfg or EquilibriumConfig(), **kw)
    torch.cuda.synchronize()
    select_move.reset_launch_count()          # this lane's run only
    with ReductionSpy(keep) as spy:
        t0 = time.perf_counter()
        res = planner.plan(state, record_trajectory=True,
                           record_free_space=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return res, seconds, select_move.launch_counts(), spy


def check_legacy_launches(what: str, res, launches: dict, spy) -> int:
    """The legacy lane launched K1's standalone reduction once per
    evaluated source (one fetch each, ``host_syncs``) and never the fused
    kernel; returns the launches."""
    n = res.stats["host_syncs"]
    check(n > 0 and launches == {"select_rows": 0, "masked_select": n,
                                 "select_rows_window": 0}
          and spy.calls == n,
          f"{what}: K1 launched {launches}, {spy.calls} reduction calls, "
          f"{n} host syncs; expected one masked_select per evaluated "
          f"source")
    return n


def legacy_breakdown(base, budget: int = 100) -> dict:
    """Where the legacy lane's time goes over the first ``budget`` moves
    of cluster B: host seconds in building the mirror (``DenseState``,
    once a plan), in ``upload`` (the packed buffer's fill and its one
    host-to-device copy), in ``select_legacy`` (issuing the mask's
    operations and K1), waiting in ``_fetch`` (the one sync a source,
    which waits for the device's work) and the rest (the scan, the row
    gathers and padding, applying and recording the moves); then the same
    moves under the profiler: device busy seconds, idle share, device
    operations and K1's device time a source."""
    from repro_torch.core import equilibrium_dense as lane
    from repro_torch.core.equilibrium import EquilibriumConfig
    from repro_torch.core.planner import create_planner
    from repro_torch.kernels import select_move
    cfg = EquilibriumConfig(max_moves=budget)
    spent: Counter = Counter()
    real = {name: getattr(lane, name)
            for name in ("DenseState", "upload", "select_legacy",
                         "_fetch")}

    def timed(name, fn):
        def call(*args, **kw):
            if name == "upload":
                spent["bytes"] += sum(a.nbytes for a in args[0].values())
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    for name, fn in real.items():
        setattr(lane, name, timed(name, fn))
    try:
        res, seconds, launches, _ = dense_lane_plan(
            "equilibrium_jax_legacy", exact_copy(base), cfg, device="cuda")
    finally:
        for name, fn in real.items():
            setattr(lane, name, fn)
    n = launches["masked_select"]
    out = {"moves": len(res.moves), "sources": n, "plan_s": seconds,
           "upload_bytes_per_source": spent["bytes"] / n,
           "host_s": {"mirror_build": spent["DenseState"],
                      "upload": spent["upload"],
                      "select_issue": spent["select_legacy"],
                      "fetch_wait": spent["_fetch"],
                      "rest": seconds - sum(spent[name] for name in real)}}

    states = [exact_copy(base) for _ in range(PROFILE_TRIES)]
    planner = create_planner("equilibrium_jax_legacy", cfg=cfg,
                             device="cuda")

    def run():
        select_move.reset_launch_count()
        planner.plan(states.pop(), record_trajectory=True,
                     record_free_space=False)
        torch.cuda.synchronize()

    def missing(rows):
        got = matching(rows, "masked_select_kernel")[1]
        want = select_move.launch_counts()["masked_select"]
        return None if got == want else f"{got} of {want} K1 launches"

    rows, wall = profiled(run, missing, "legacy lane")
    busy_ms = sum(ms for ms, _ in rows.values())
    k1_ms, _ = matching(rows, "masked_select_kernel")
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:8]
    out["profile"] = {
        "wall_s": wall, "device_busy_s": busy_ms / 1e3,
        "idle_share": 1.0 - busy_ms / 1e3 / wall,
        "device_ops_per_source": sum(k for _, k in rows.values()) / n,
        "k1_device_ms_per_source": k1_ms / n,
        "top": [{"name": k[:80], "device_ms": ms, "calls": c}
                for k, (ms, c) in top]}
    return out


def phase_dense_lanes(card: str, base, full: dict) -> dict:
    """The dense lanes on the card: ``equilibrium_jax_legacy`` (K1's
    standalone reduction once per evaluated source) and the host
    ``equilibrium``, with and without source bounds, on four small
    clusters at the default and the slack regression's config against the
    faithful planner; then both lanes to convergence on exact copies of
    cluster B against phase 3's plan, the first ``LEGACY_HELD`` legacy
    launches held bitwise to the plain version on the same masks."""
    from repro_torch.core import clustergen
    from repro_torch.core.equilibrium import EquilibriumConfig
    from repro_torch.core.planner import create_planner
    from repro_torch.kernels.ref import masked_select_ref
    t0 = time.perf_counter()
    small, small_launches = [], 0
    for name, max_moves in (("small_test_cluster", None), ("cluster_a", None),
                            ("cluster_c", 200), ("cluster_f", 200)):
        built = getattr(clustergen, name)()
        for label, kw in (("default", {}), ("slack", SLACK_CFG)):
            if max_moves is not None:
                kw = dict(kw, max_moves=max_moves)
            cfg = EquilibriumConfig(**kw)
            ref = create_planner("equilibrium_faithful", cfg=cfg).plan(
                exact_copy(built), record_trajectory=True,
                record_free_space=False)
            ref_b = create_planner("equilibrium_faithful", cfg=cfg,
                                   source_bounds=True).plan(exact_copy(built))
            for lane, extra in (("equilibrium_jax_legacy",
                                 {"device": "cuda"}),
                                ("equilibrium", {}),
                                ("equilibrium", {"source_bounds": True})):
                what = f"{name} {label} {lane} {extra}"
                res, _, launches, spy = dense_lane_plan(
                    lane, exact_copy(built), cfg, **extra)
                check(len(res.moves) > 0 and same_plan(ref, res),
                      f"{what}: differs from the faithful planner")
                if lane == "equilibrium_jax_legacy":
                    small_launches += check_legacy_launches(what, res,
                                                            launches, spy)
                else:
                    check(launches == {"select_rows": 0, "masked_select": 0,
                                       "select_rows_window": 0}
                          and spy.calls == 0, f"{what}: launched K1")
                if extra.get("source_bounds"):
                    check((res.stats["bound_hits"],
                           res.stats["pruned_sources"])
                          == (ref_b.stats["bound_hits"],
                              ref_b.stats["pruned_sources"]),
                          f"{what}: certificate counters")
            small.append({"cluster": name, "config": label,
                          "moves": len(ref.moves),
                          "bound_hits": ref_b.stats["bound_hits"]})
    small_s = time.perf_counter() - t0

    want = bench_row("planner.tail.B1x.batch-nobounds")
    lanes = {}
    for lane, extra in (("equilibrium_jax_legacy", {"device": "cuda"}),
                        ("equilibrium", {})):
        legacy = lane == "equilibrium_jax_legacy"
        res, seconds, launches, spy = dense_lane_plan(
            lane, exact_copy(base), keep=LEGACY_HELD if legacy else 0,
            **extra)
        hist = {int(k): v for k, v in res.stats["sources_tried_hist"].items()}
        n = len(res.moves)
        check(as_tuples(res.moves) == full["move_list"],
              f"cluster B {lane}: {n} moves, not phase 3's "
              f"{len(full['move_list'])}")
        check(hist == want["tried_hist"],
              f"cluster B {lane}: sources_tried histogram differs from "
              f"planner.tail.B1x.batch-nobounds")
        row = {"moves": n, "plan_s": seconds, "moves_per_s": n / seconds,
               "sources_tried": sum(k * v for k, v in hist.items()),
               "host_syncs": res.stats["host_syncs"],
               "k1_launches": launches}
        if legacy:
            evaluated = check_legacy_launches(f"cluster B {lane}", res,
                                              launches, spy)
            worst = 0
            for valid, util, any_k, dst_k in spy.held:
                any_p, dst_p = masked_select_ref(valid, util)
                worst = max(worst, int((dst_k.long() - dst_p.long())
                                       .abs().max()))
                check(torch.equal(any_k, any_p) and torch.equal(dst_k, dst_p),
                      "cluster B legacy lane: a K1 launch differs from its "
                      "plain version on the same mask")
            # the kernel's times at the lane's own shape: the first
            # held launch's mask (its timing launches come after the
            # count was read)
            row.update(evaluated_sources=evaluated,
                       ms_per_source=seconds / evaluated * 1e3,
                       held_bitwise=len(spy.held), max_abs_err=worst,
                       mask_shapes=sorted({tuple(v.shape)
                                           for v, *_ in spy.held}),
                       k1_at_lane_shape=time_masked_select(
                           *spy.held[0][:2]))
        lanes[lane] = row
    lanes["equilibrium_jax_legacy"]["breakdown"] = legacy_breakdown(base)
    out = {"card": card, "small_runs": 3 * len(small),
           "small_legacy_launches": small_launches, "small_s": small_s,
           "small": small, "cluster_b": lanes,
           "cluster_b_reference": "planner.tail.B1x.batch-nobounds",
           "cap": None}
    emit("dense_lanes", **out)
    return out


# ---------------------------------------------------------------------------
# phase 4d: the simulator (the Table-1 replay, the cluster-B lifecycle,
# the six scenarios)

#: the throttled replay's tick cap (phase 3's plan drains in far fewer)
REPLAY_MAX_TICKS = 10_000
#: the cluster-B lifecycle's length in ticks
LIFECYCLE_TICKS = 24


def phase_replay(card: str, base, full: dict) -> dict:
    """Phase 3's plan replayed through the port's ``simulate`` and
    ``simulate_throttled`` at cluster B (the paper's Table-1 quantities);
    the same moves drained through a :class:`MovementThrottle` by hand,
    its ledger checked each tick, must end with an empty backlog and the
    physical bytes equal to the target map's."""
    from repro_torch.core import (MovementThrottle, ThrottleConfig, simulate,
                                  simulate_throttled)
    moves = full["moves"]
    throttle = ThrottleConfig()
    t0 = time.perf_counter()
    res = simulate(base, moves, record_trajectory=False)
    simulate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    thr = simulate_throttled(base, moves, throttle,
                             max_ticks=REPLAY_MAX_TICKS)
    throttled_s = time.perf_counter() - t0
    state = base.copy()
    for mv in moves:
        state.apply(mv)
    q = MovementThrottle(throttle)
    q.enqueue(moves)
    ticks = 0
    while q.backlog_moves and ticks < REPLAY_MAX_TICKS:
        q.tick()
        ticks += 1
        check_ledger(q, f"replay tick {ticks}")
    phys, used = q.physical_used(state), state.used()
    check(q.backlog_moves == 0 and ticks == thr.ticks,
          f"throttled replay: {q.backlog_moves} transfers left after "
          f"{ticks} ticks (simulate_throttled: {thr.ticks})")
    check(np.allclose(phys, used, rtol=1e-12, atol=0.0),
          f"throttled replay: physical bytes differ from the target map's "
          f"by {float(np.abs(phys - used).max())}")
    # the throttle sums bytes a tick at a time, simulate a move at a time
    check(res.moves_applied == len(full["move_list"])
          and np.isclose(thr.moved_bytes, res.moved_bytes, rtol=1e-12,
                         atol=0.0)
          and thr.variance_target == res.variance_after,
          f"throttled and plain replays disagree: moved bytes "
          f"{thr.moved_bytes} and {res.moved_bytes}, target variance "
          f"{thr.variance_target} and {res.variance_after}")
    out = {"card": card, "moves": res.moves_applied,
           "gained_free_space": res.gained_free_space,
           "free_before": res.free_before, "free_after": res.free_after,
           "moved_bytes": res.moved_bytes,
           "variance_before": res.variance_before,
           "variance_after": res.variance_after,
           "variance_by_class_before": res.variance_by_class_before,
           "variance_by_class_after": res.variance_by_class_after,
           "throttle": {"max_concurrent": throttle.max_concurrent,
                        "device_bytes_per_tick":
                            throttle.device_bytes_per_tick},
           "throttled_ticks": thr.ticks,
           "throttled_max_in_flight": int(thr.in_flight_trajectory.max()),
           "physical_variance_first_last": [
               float(thr.variance_trajectory[0]),
               float(thr.variance_trajectory[-1])],
           "simulate_s": simulate_s, "simulate_throttled_s": throttled_s}
    emit("cluster_b_replay", **out)
    return out


def check_ledger(q, what: str) -> dict:
    """The throttle's two byte-conservation invariants, as a gate."""
    try:
        return q.check_conservation()
    except AssertionError as e:
        fail(f"{what}: {e}")


def lifecycle_timeline(base) -> tuple:
    """The cluster-B lifecycle (after the reference's ``churn-heavy``, at
    cluster B's own pools and hosts): growth of the two largest pools, a
    drain, a 12-OSD host of the mean HDD size, a failure on another host,
    a new EC 8+3 pool and its growth, foreign upmaps and an SSD; a
    rebalance every tick.  Returns ``(events, SimConfig)``."""
    from repro_torch.core import GiB, PlacementRule, ThrottleConfig, TiB
    from repro_torch.core.clustergen import PiB
    from repro_torch.sim import (DeviceAdd, DeviceFail, DeviceOut,
                                 ForeignMovement, HostAdd, PoolCreate,
                                 PoolGrowth, RebalanceTick, SimConfig)
    ticks = LIFECYCLE_TICKS
    util = base.utilization()
    hdds = sorted((d for d in base.devices if d.device_class == "hdd"),
                  key=lambda d: (-util[base.idx(d.id)], d.id))
    out_dev = hdds[0]                               # the fullest HDD
    fail_dev = next(d for d in hdds if d.host != out_dev.host)
    new_pool = 1 + max(base.pools)
    events = [RebalanceTick(t) for t in range(ticks)]
    events += [
        PoolGrowth(0, pool_id=0, bytes_per_tick=10 * TiB, duration=ticks,
                   every=2),
        PoolGrowth(0, pool_id=2, bytes_per_tick=5 * TiB, duration=ticks,
                   every=2),
        DeviceOut(4, osd_id=out_dev.id),
        HostAdd(6, n_osds=12, capacity_each=5 * PiB / 810,
                device_class="hdd"),
        DeviceFail(8, osd_id=fail_dev.id),
        PoolCreate(10, name="fresh", pg_count=256,
                   rule=PlacementRule.erasure(8, 3, "host", "hdd"), ec_k=8,
                   stored_bytes=1 * TiB),
        PoolGrowth(11, pool_id=new_pool, bytes_per_tick=2 * TiB,
                   duration=ticks - 11, every=2),
        ForeignMovement(12, count=32),
        DeviceAdd(14, capacity=1 * PiB / 185, device_class="ssd"),
    ]
    cfg = SimConfig(ticks=ticks, moves_per_tick=64,
                    throttle=ThrottleConfig(max_concurrent=64,
                                            device_bytes_per_tick=512 * GiB),
                    seed=0)
    return events, cfg


def drive_lifecycle(state, events, cfg, balancer: str, device=None) -> dict:
    """One :class:`ScenarioEngine` run, tick by tick, under the tracer:
    the throttle's ledger checked after every tick, each plan's moves
    kept, and each tick's host seconds split into the plan (its chunks,
    its sync: the cold build or an absorb, and the rest) and the engine's
    own work (the metrics' ``collect``, the throttle's ``tick`` and the
    events: growth, drains, expansion, foreign draws, pool creates and
    the transfers they and the plan enqueue, whose seconds and count are
    also kept apart).  ``device`` reaches the planner; the batch lane's planner
    is bound to ``state`` before the first tick, so that its ``sync`` can
    be timed."""
    from repro_torch import obs
    from repro_torch.sim import ScenarioEngine
    cfg = dataclasses.replace(cfg, balancer=balancer)
    engine = ScenarioEngine(state, events, cfg, device=device)
    planner = engine._planner
    spent: Counter = Counter()
    plans: list[list] = []

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    impl = planner._bind(state) if balancer == "equilibrium_batch" else None
    if impl is not None:
        impl.sync = timed("sync", impl.sync)
    plan = timed("plan", planner.plan)

    def recorded(st, **kw):
        res = plan(st, **kw)
        plans.append(as_tuples(res.moves))
        spent["chunks"] += res.stats.get("selection_seconds", 0.0)
        spent["host_syncs"] += res.stats.get("host_syncs", 0)
        return res

    planner.plan = recorded
    engine.metrics.collect = timed("collect", engine.metrics.collect)
    engine.throttle.tick = timed("throttle", engine.throttle.tick)
    enqueue = timed("enqueue", engine.throttle.enqueue)

    def counted(moves, *args, **kw):
        spent["enqueued"] += len(moves)
        return enqueue(moves, *args, **kw)

    engine.throttle.enqueue = counted
    reg = obs.registry()
    snap = reg.snapshot()
    rows = []
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    with obs.tracing() as tr:
        t_run = time.perf_counter()
        for t in range(cfg.ticks):
            before = dict(spent)
            t0 = time.perf_counter()
            engine.step(t)
            tick_s = time.perf_counter() - t0
            check_ledger(engine.throttle, f"{balancer} lifecycle tick {t}")
            part = {k: spent[k] - before.get(k, 0.0) for k in spent}
            plan_s = part.get("plan", 0.0)
            sync_s = part.get("sync", 0.0)
            chunks_s = part.get("chunks", 0.0)
            rows.append({
                "tick": t, "moves": len(plans[-1]) if plans else 0,
                "host_syncs": int(part.get("host_syncs", 0)),
                "tick_s": tick_s, "plan_s": plan_s, "chunks_s": chunks_s,
                "absorb_s": sync_s,
                "plan_rest_s": plan_s - chunks_s - sync_s,
                "engine_s": tick_s - plan_s,
                "collect_s": part.get("collect", 0.0),
                "throttle_s": part.get("throttle", 0.0),
                "events_s": (tick_s - plan_s - part.get("collect", 0.0)
                             - part.get("throttle", 0.0)),
                "enqueue_s": part.get("enqueue", 0.0),
                "enqueued": int(part.get("enqueued", 0)),
                "backlog": engine.throttle.backlog_moves})
        seconds = time.perf_counter() - t_run
    engine.state.check_valid()
    absorbs = [r["args"] for r in tr.records
               if r.get("name") == "batch.absorb"]
    return {"engine": engine, "plans": plans, "ticks": rows,
            "seconds": seconds, "deltas": reg.deltas_since(snap),
            "absorbs": absorbs,
            "json": json.dumps(engine.metrics.to_dict(), sort_keys=True)}


def phase_lifecycle(card: str, base) -> dict:
    """The simulator at cluster B: one :class:`ScenarioEngine` with the
    warm ``equilibrium_batch`` on the card through
    :func:`lifecycle_timeline`, on an exact copy of phase 3's cluster; the
    same timeline on another exact copy through the host ``equilibrium``
    lane (no code shared with the batch engine).  Gates: metrics JSON and
    each tick's planned moves equal; one rebuild (the cold build); K1's
    ``select_rows`` once a step and the standalone ``masked_select``
    never; host syncs = chunks + re-pads + non-structural absorbs; the
    throttle's ledger balanced every tick; both states valid at the
    end."""
    from repro_torch.kernels import select_move
    from repro_torch.sim import RebalanceTick, ScenarioEngine
    events, cfg = lifecycle_timeline(base)
    select_move.reset_launch_count()          # the lifecycle's run only
    batch = drive_lifecycle(exact_copy(base), events, cfg,
                            "equilibrium_batch", device="cuda")
    launches = select_move.launch_counts()
    host = drive_lifecycle(exact_copy(base), events, cfg, "equilibrium")
    for t, (a, b) in enumerate(zip(batch["plans"], host["plans"])):
        check(a == b, f"lifecycle tick {t}: the batch lane planned "
              f"{len(a)} moves, the host lane {len(b)}, not the same")
    check(len(batch["plans"]) == len(host["plans"]) == cfg.ticks,
          "lifecycle: plans per lane")
    check(batch["json"] == host["json"],
          "lifecycle: metrics JSON differs between the batch and host lanes")
    d = batch["deltas"]
    chunks = int(d.get("batch.chunks", 0))
    repads = int(d.get("batch.repads", 0))
    rebuilds = int(d.get("batch.rebuilds", 0))
    syncs = int(d.get("batch.host_syncs", 0))
    by_path = Counter("structural" if a["structural"] else "non_structural"
                      for a in batch["absorbs"])
    check(rebuilds == 1, f"lifecycle: {rebuilds} rebuilds, expected 1 (the "
          f"cold build)")
    check(launches == {"select_rows": chunks * cfg.moves_per_tick,
                       "masked_select": 0,
                       "select_rows_window": 0},
          f"lifecycle: K1 launched {launches} over {chunks} chunks of "
          f"{cfg.moves_per_tick} steps")
    check(syncs == chunks + repads + by_path["non_structural"],
          f"lifecycle: host syncs {syncs} != chunks {chunks} + re-pads "
          f"{repads} + non-structural absorbs {by_path['non_structural']}")
    summary = batch["engine"].metrics.summary()
    out = {"card": card, "osds_start": base.n_devices,
           "osds_end": batch["engine"].state.n_devices,
           "pgs_end": len(batch["engine"].state.acting),
           "ticks": cfg.ticks, "moves_per_tick": cfg.moves_per_tick,
           "events": [ScenarioEngine._describe(ev) for ev in events
                      if not isinstance(ev, RebalanceTick)],
           "moves_planned": sum(len(p) for p in batch["plans"]),
           "rebuilds": rebuilds, "absorb_runs": int(d.get("absorb.runs", 0)),
           "absorb_runs_by_path": dict(by_path), "chunks": chunks,
           "repads": repads, "select_rows_launches": launches["select_rows"],
           "masked_select_launches": launches["masked_select"],
           "host_syncs": syncs, "seconds_batch": batch["seconds"],
           "seconds_host": host["seconds"],
           "final_variance": summary["final_variance"],
           "total_transferred_bytes": summary["total_transferred_bytes"],
           "max_backlog": max(r["backlog"] for r in batch["ticks"]),
           "largest_enqueue": max(r["enqueued"] for r in batch["ticks"]),
           "per_tick_batch": batch["ticks"],
           "per_tick_host": [{k: r[k] for k in ("tick", "moves", "tick_s",
                                                "plan_s", "engine_s")}
                             for r in host["ticks"]]}
    emit("cluster_b_lifecycle", **out)
    return out | {"plans": batch["plans"], "json": batch["json"]}


def phase_scenarios(card: str) -> dict:
    """The six scenarios at full length with ``equilibrium_batch`` on the
    card (the planner's default device), each run's metrics byte for byte
    those of the committed ``BENCH_scenarios.json``; K1's launches per
    scenario."""
    from repro_torch import obs
    from repro_torch.kernels import select_move
    from repro_torch.sim import SCENARIOS, run_scenario
    want = json.loads((ROOT / "BENCH_scenarios.json").read_text())
    reg = obs.registry()
    rows = {}
    for name in sorted(SCENARIOS):
        ref = want["scenarios"][name]["equilibrium_batch"]
        chunk = SCENARIOS[name].build(0, False)[2].moves_per_tick
        snap = reg.snapshot()
        select_move.reset_launch_count()
        t0 = time.perf_counter()
        got = run_scenario(name, "equilibrium_batch", seed=0, quick=False)
        seconds = time.perf_counter() - t0
        launches = select_move.launch_counts()
        d = reg.deltas_since(snap)
        check(json.dumps(got["metrics"], sort_keys=True)
              == json.dumps(ref["metrics"], sort_keys=True),
              f"scenario {name}: metrics differ from BENCH_scenarios.json")
        chunks = int(d.get("batch.chunks", 0))
        check(chunks > 0 and launches == {"select_rows": chunks * chunk,
                                          "masked_select": 0,
                                          "select_rows_window": 0},
              f"scenario {name}: K1 launched {launches} over {chunks} "
              f"chunks of {chunk} steps")
        check(int(d.get("batch.rebuilds", 0)) == 1,
              f"scenario {name}: {d.get('batch.rebuilds', 0)} rebuilds, "
              f"expected 1 (the cold build)")
        rows[name] = {"ticks": got["ticks"], "seconds": seconds,
                      "moves": got["metrics"]["summary"][
                          "total_planned_moves"],
                      "select_rows_launches": launches["select_rows"],
                      "chunks": chunks,
                      "rebuilds": int(d.get("batch.rebuilds", 0)),
                      "absorb_runs": int(d.get("absorb.runs", 0)),
                      "host_syncs": int(d.get("batch.host_syncs", 0))}
    out = {"card": card, "identical": True,
           "reference": "BENCH_scenarios.json",
           "seconds": sum(r["seconds"] for r in rows.values()),
           "select_rows_launches": sum(r["select_rows_launches"]
                                       for r in rows.values()),
           "scenarios": rows}
    emit("scenarios", **out)
    return out


# ---------------------------------------------------------------------------
# phase 4e: the differential fuzzer (``repro_torch.fuzz``) on the card

#: the generated sweep: ``generate_timeline`` seeds by profile
FUZZ_SWEEP = (("quick", range(0, 32)), ("nightly", range(0, 8)))
#: the host lanes whose moves and metrics JSON phase ``fuzz`` keeps for
#: phase ``batch_optins``, by timeline label and engine
FUZZ_HELD = ("equilibrium_faithful", "equilibrium")
FUZZ_LANES: dict[str, dict[str, tuple]] = {}


def fuzz_runs(timelines) -> dict:
    """Each ``(label, timeline)`` through the port's whole
    ``"equilibrium"`` class on the card (the harness's default device),
    the ``mgr`` and ``none`` baselines and the replay, every oracle a
    gate.  Counts what K1 must have launched: one ``select_rows`` a step
    of the batch lane's chunks and one a step of the fleet lane's (a
    fleet of one: a bucket chunk is ``moves_per_tick`` steps), one window
    launch a step of the sharded lane's (one rank, in this process), one
    ``masked_select`` per source the legacy lane evaluated (its fetches,
    ``dense.host_syncs``).  Each lane's seconds and batch-engine chunks
    are summed by engine (the replay's lane under its reference engine's
    name)."""
    from repro_torch import fuzz, obs
    from repro_torch.fuzz import harness
    reg = obs.registry()
    moves = lanes = steps = fleet_steps = sharded_steps = 0
    sources = reg.get("dense.host_syncs")
    per = {}
    lane_s: Counter = Counter()
    lane_chunks: Counter = Counter()
    run_lane = harness.run_lane

    def timed_lane(tl, engine, *args, **kw):
        t = time.perf_counter()
        chunks = reg.get("batch.chunks")
        try:
            return run_lane(tl, engine, *args, **kw)
        finally:
            lane_s[engine] += time.perf_counter() - t
            lane_chunks[engine] += int(reg.get("batch.chunks") - chunks)

    t0 = time.perf_counter()
    for label, tl in timelines:
        snap = reg.snapshot()
        lane_chunks.clear()
        t1 = time.perf_counter()
        harness.run_lane = timed_lane
        try:
            got = fuzz.run_timeline(tl)
        except fuzz.OracleFailure as e:
            fail(f"fuzz {label}: {e}")
        finally:
            harness.run_lane = run_lane
        d = reg.deltas_since(snap)
        per_chunk = max(1, int(tl.sim["moves_per_tick"]))
        check(sum(lane_chunks.values()) == int(d.get("batch.chunks", 0)),
              f"fuzz {label}: batch chunks by lane {dict(lane_chunks)}")
        steps += lane_chunks["equilibrium_batch"] * per_chunk
        sharded_steps += lane_chunks["equilibrium_batch_sharded"] * per_chunk
        fleet_steps += int(d.get("fleet.chunks", 0)) * per_chunk
        for engine in ("equilibrium_batch", "fleet",
                       "equilibrium_batch_sharded"):
            check(got[engine].rebuilds == 1,
                  f"fuzz {label}: the {engine} lane rebuilt "
                  f"{got[engine].rebuilds} times")
        moves += got["equilibrium"].planned_moves
        lanes += len(got) + 1                      # the replay's lane
        FUZZ_LANES[label] = {e: (got[e].moves, got[e].metrics_json)
                             for e in FUZZ_HELD}
        per[label] = {"lanes": sorted(got),
                      "moves": got["equilibrium"].planned_moves,
                      "seconds": time.perf_counter() - t1}
    return {"timelines": len(per), "lanes": lanes, "moves": moves,
            "batch_steps": steps, "fleet_steps": fleet_steps,
            "sharded_steps": sharded_steps,
            "legacy_sources": int(reg.get("dense.host_syncs") - sources),
            "seconds": time.perf_counter() - t0,
            "lane_seconds": dict(sorted(lane_s.items())),
            "per_timeline": per}


def phase_fuzz(card: str, base, life: dict) -> dict:
    """The fuzzer's oracles on the card: the generated sweep
    (:data:`FUZZ_SWEEP`), the four ``tests/regressions`` timelines
    through the whole class (the slack regression through the card's
    legacy lane), and phase ``cluster_b_lifecycle``'s timeline through the
    warm ``equilibrium_batch`` on the card behind the harness's replay
    proxy (every move replayed through ``move_is_legal`` and ``apply`` on
    a pre-plan copy, the variance never rising, the throttle's ledger
    every tick, at most one rebuild), its moves, metrics, rebuilds and
    ``select_rows`` launches those of phase ``cluster_b_lifecycle``."""
    from repro_torch import fuzz, obs
    from repro_torch.fuzz.harness import run_lifecycle
    from repro_torch.kernels import select_move
    from repro_torch.sim import generate_timeline
    reg = obs.registry()
    snap = reg.snapshot("fuzz.")
    groups = {profile: [(f"{profile} seed {seed}",
                         generate_timeline(seed, profile))
                        for seed in seeds]
              for profile, seeds in FUZZ_SWEEP}
    groups["corpus"] = [(path.stem, fuzz.load_timeline(path))
                        for path in fuzz.iter_corpus()]
    runs, launches = {}, {}
    for name, timelines in groups.items():
        select_move.reset_launch_count()
        runs[name] = fuzz_runs(timelines)
        got = select_move.launch_counts()
        # the batch lanes' and the legacy lanes' launches by kernel, the
        # fleet lanes' select_rows under a key of their own, the sharded
        # lanes' window launches under theirs
        launches[name] = {"select_rows": runs[name]["batch_steps"],
                          "masked_select": runs[name]["legacy_sources"],
                          "fleet_select_rows": runs[name]["fleet_steps"],
                          "select_rows_window": runs[name]["sharded_steps"]}
        check(got == {"select_rows": runs[name]["batch_steps"]
                      + runs[name]["fleet_steps"],
                      "masked_select": runs[name]["legacy_sources"],
                      "select_rows_window": runs[name]["sharded_steps"]}
              and min(launches[name].values()) > 0,
              f"fuzz {name}: K1 launched {got}, the batch lanes ran "
              f"{runs[name]['batch_steps']} steps, the fleet lanes "
              f"{runs[name]['fleet_steps']}, the sharded lanes "
              f"{runs[name]['sharded_steps']} and the legacy lanes "
              f"evaluated {runs[name]['legacy_sources']} sources")
    slack = runs["corpus"]["per_timeline"].get("legacy-slack-divergence")
    check(runs["corpus"]["timelines"] == 4 and slack is not None
          and "equilibrium_jax_legacy" in slack["lanes"],
          f"fuzz corpus: {sorted(runs['corpus']['per_timeline'])}")
    sweep = {name: {k: v for k, v in runs[name].items()
                    if k != "per_timeline"}
             | {"seeds": f"{seeds.start}:{seeds.stop}"}
             for name, seeds in FUZZ_SWEEP}
    deltas = reg.deltas_since(snap, "fuzz.")
    failures = {k: v for k, v in deltas.items()
                if k.startswith("fuzz.oracle_failures")}
    check(not failures, f"fuzz: oracle failures {failures}")

    events, cfg = lifecycle_timeline(base)
    cfg = dataclasses.replace(cfg, balancer="equilibrium_batch")
    snap_b = reg.snapshot()
    select_move.reset_launch_count()
    t0 = time.perf_counter()
    try:
        lane = run_lifecycle(exact_copy(base), events, cfg,
                             "equilibrium_batch")
    except fuzz.OracleFailure as e:
        fail(f"fuzz at cluster B: {e}")
    full_s = time.perf_counter() - t0
    full_launches = select_move.launch_counts()
    want = [mv for plan in life["plans"] for mv in plan]
    check([mv[:4] for mv in lane.moves] == want
          and lane.metrics_json == life["json"],
          f"fuzz at cluster B: {lane.planned_moves} moves replayed, phase "
          f"cluster_b_lifecycle planned {len(want)}; the moves or metrics "
          f"differ")
    check(lane.rebuilds == life["rebuilds"] == 1
          and full_launches == {"select_rows": life["select_rows_launches"],
                                "masked_select": 0,
                                "select_rows_window": 0},
          f"fuzz at cluster B: {lane.rebuilds} rebuilds, K1 launched "
          f"{full_launches}; phase cluster_b_lifecycle: {life['rebuilds']} "
          f"and {life['select_rows_launches']}")
    d_b = reg.deltas_since(snap_b)
    checks = {k[len("fuzz.oracle_checks{oracle="):-1]: int(v)
              for k, v in sorted(deltas.items())
              if k.startswith("fuzz.oracle_checks")}
    out = {"card": card,
           "sweep": sweep,
           "sweep_seconds": sum(r["seconds"] for r in sweep.values()),
           "corpus_seconds": runs["corpus"]["seconds"],
           "timelines": int(deltas.get("fuzz.timelines", 0)),
           "lanes": int(sum(v for k, v in deltas.items()
                            if k.startswith("fuzz.lanes"))),
           "oracle_checks": checks, "oracle_failures": 0,
           "k1_launches": launches, "corpus": runs["corpus"],
           "fleet_lane": {
               "seconds": sum(r["lane_seconds"].get("fleet", 0.0)
                              for r in runs.values()),
               "select_rows_launches": {
                   name: launches[name]["fleet_select_rows"]
                   for name in runs}},
           "sharded_lane": {
               "seconds": sum(r["lane_seconds"].get(
                   "equilibrium_batch_sharded", 0.0) for r in runs.values()),
               "select_rows_window_launches": {
                   name: launches[name]["select_rows_window"]
                   for name in runs}},
           "cluster_b": {
               "moves_replayed": lane.planned_moves, "ticks": cfg.ticks,
               "rebuilds": lane.rebuilds,
               "absorb_runs": int(d_b.get("absorb.runs", 0)),
               "k1_launches": full_launches, "seconds": full_s,
               "seconds_unproxied": life["seconds_batch"]}}
    emit("fuzz", **out)
    return out


# ---------------------------------------------------------------------------
# phase batch_optins: the batch engine's opt-ins (the legality cache
# through K1's cached instantiation, device telemetry, pipelined dispatch)

#: the opt-ins' registry counters, as ``batch.<name>``
OPTIN_COUNTERS = ("tiles_walked", "cand_tiles", "cache_hits", "cache_misses",
                  "cache_repairs", "chunks_overlapped", "repads",
                  "stash_moves")
#: the reference engine's counters at cluster B (tests/_ref_batch_counters.py)
REF_COUNTERS = ROOT / "tests" / "fixtures" / "batch_counters_cluster_b.json"
#: plan-time turns per (legality_cache, pipeline) configuration (five
#: before phase ``shard`` joined the run's time limit)
OPTIN_TURNS = 2


def counted(state, traced: bool = True, **options) -> dict:
    """One plan of ``state`` to convergence through
    ``create_planner("equilibrium_batch", **options)`` (under a tracer
    where ``traced``): its moves, ``sources_tried`` histogram, certificate
    counters, opt-in counters, chunks, host syncs and plan seconds."""
    import contextlib
    from repro_torch import obs
    from repro_torch.core.planner import create_planner
    planner = create_planner("equilibrium_batch", **options)
    reg = obs.registry()
    snap = reg.snapshot()
    with obs.tracing() if traced else contextlib.nullcontext():
        t0 = time.perf_counter()
        res = planner.plan(state, record_free_space=False)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    d = reg.deltas_since(snap)
    st = res.stats
    return {"moves": as_tuples(res.moves),
            "tried_hist": {int(k): v for k, v in
                           st["sources_tried_hist"].items()},
            "bound_hits": st["bound_hits"],
            "pruned_sources": st["pruned_sources"],
            **{key: int(d.get(f"batch.{key}", 0)) for key in OPTIN_COUNTERS},
            "chunks": int(d.get("batch.chunks", 0)),
            "host_syncs": st["host_syncs"], "seconds": secs}


def check_cluster_b(what: str, got: dict, want: dict, bench: dict,
                    steps: int, cache: bool) -> dict:
    """A traced plan of cluster B to convergence (:func:`counted`, K1's
    counts reset just before it) of ``steps`` steps against
    ``planner.tail.B1x``'s row ``bench`` and the reference engine's run
    ``want`` in ``tests/fixtures/batch_counters_cluster_b.json``: the
    moves, histogram and certificate counters, every opt-in counter, one
    host sync a chunk (and a re-pad), ``select_rows`` once a step (all
    cached where ``cache``) and ``masked_select`` never.  Returns the
    run's record."""
    from repro_torch.kernels import select_move
    launches = select_move.launch_counts()
    cached = select_move.cached_launch_count()
    want_hist = {int(k): v for k, v in want["sources_tried_hist"].items()}
    check(len(got["moves"]) == bench["converged"] == want["moves"],
          f"cluster B {what}: {len(got['moves'])} moves")
    check(got["tried_hist"] == bench["tried_hist"] == want_hist
          and got["bound_hits"] == bench["bound_hits"] == want["bound_hits"]
          and got["pruned_sources"] == bench["pruned_sources"]
          == want["pruned_sources"],
          f"cluster B {what}: histogram or certificate counters "
          f"{got['bound_hits']} / {got['pruned_sources']}")
    differ = {key: (got[key], want[f"batch.{key}"]) for key in OPTIN_COUNTERS
              if got[key] != want[f"batch.{key}"]}
    check(not differ, f"cluster B {what}: counters differ from the "
                      f"reference engine's: {differ}")
    check(got["host_syncs"] == got["chunks"] + got["repads"],
          f"cluster B {what}: {got['host_syncs']} host syncs over "
          f"{got['chunks']} chunks")
    check(launches == {"select_rows": steps, "masked_select": 0,
                       "select_rows_window": 0}
          and cached == (steps if cache else 0),
          f"cluster B {what}: K1 launched {launches} ({cached} cached) "
          f"over {steps} steps")
    return {"moves": len(got["moves"]), "chunks": got["chunks"],
            "host_syncs": got["host_syncs"], "k1_launches": steps,
            "k1_cached_launches": cached,
            "counters": {key: got[key] for key in OPTIN_COUNTERS},
            "bound_hits": got["bound_hits"],
            "pruned_sources": got["pruned_sources"],
            "traced_seconds": got["seconds"]}


def plan_turns(base, configs: dict, turns: int, moves: int) -> dict:
    """Untraced plans of cluster B to convergence on the card, one of
    each of ``configs`` (name: planner options) a turn, each of
    ``moves`` moves: their seconds by name."""
    secs = {name: [] for name in configs}
    for _ in range(turns):
        for name, kw in configs.items():
            rec = counted(exact_copy(base), traced=False, device="cuda", **kw)
            check(len(rec["moves"]) == moves,
                  f"cluster B {name}: {len(rec['moves'])} moves")
            secs[name].append(rec["seconds"])
    return secs


def cached_case(args, cache, smem_limit=None) -> bool:
    """K1's cached instantiation against its plain version on the card
    with the same cache, bitwise: any, dst, cand_src, cand_row and the
    cache each writes."""
    from repro_torch.kernels import select_move
    from repro_torch.kernels.ref import select_rows_ref
    dev = args[0].device
    cache = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
             for k, v in cache.items()}
    out_k, out_p = cache["cache_ok"].clone(), cache["cache_ok"].clone()
    got = select_move.select_rows_fwd(*args, smem_limit=smem_limit, **cache,
                                      cache_out=out_k, cand_row=True)
    want = select_rows_ref(*args, **cache, cache_out=out_p, cand_row=True)
    torch.cuda.synchronize()
    return (all(torch.equal(g, w) for g, w in zip(got, want))
            and torch.equal(out_k, out_p))


def k1_cached(card: str, base_b, k1: dict) -> dict:
    """K1's cached instantiation: bitwise against its plain version on
    the test carries in each cache state (every block a miss, every block
    a hit, a tag mismatch), on the engine's own cache after planning
    steps with it, and at cluster B's first step in each state, staged
    and from device memory; its kernel, plain and bound times at cluster
    B's first step with every block a miss (the cache written) and a hit
    (the cache read), in turns with the uncached instantiation."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _select_rows_carries import (CARRIES, cache_states, carry,
                                      carry_id, engine_cache, to_device)
    from repro_torch.core.equilibrium_batch import BatchPlanner
    from repro_torch.kernels import select_move
    from repro_torch.kernels.ref import select_rows_ref
    dev = torch.device("cuda")
    select_move.reset_launch_count()
    cases = 0
    for case in CARRIES:
        args = carry(*case)
        for name, cache, _ in cache_states(args):
            cases += 1
            check(cached_case(to_device(args, dev), cache),
                  f"cached select_rows differs from its plain version on "
                  f"{carry_id(case)} ({name})")
    for cluster, legal in (("small_test_cluster", False),
                           ("cluster_a", False), ("cluster_a", True)):
        args, cache = engine_cache(cluster, 60, legal_hit=legal)
        cases += 1
        check(cached_case(to_device(args, dev), cache),
              f"cached select_rows differs from its plain version on "
              f"{cluster}'s own cache")
    planner = BatchPlanner(base_b.copy(), legality_cache=True, device="cuda")
    planner.sync()
    step = planner._step
    _, src_order, n_avail = step.sources()
    args_b = (src_order, n_avail, step.cap_lim, step.dyn, step.const,
              step.scal)
    states_b = {name: cache for name, cache, _ in cache_states(args_b)}
    for name, cache in states_b.items():
        for limit in (None, 0):
            cases += 1
            check(cached_case(args_b, cache, limit),
                  f"cached select_rows differs from its plain version at "
                  f"cluster B's first step ({name}, smem_limit {limit})")
    check(select_move.cached_launch_count() == cases,
          f"cached launches {select_move.cached_launch_count()} of "
          f"{cases} cases")

    bound = select_move.SelectRows(*args_b[2:])
    calls = {"uncached": lambda: bound(*args_b[:2])}
    for name in ("miss", "hit"):
        cache = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                 for k, v in states_b[name].items()}
        out = cache["cache_ok"].clone()
        calls[name] = (lambda c=cache, o=out: bound(
            *args_b[:2], **c, cache_out=o, cand_row=True))
    turns = {name: [] for name in calls}
    for _ in range(3):
        for name, fn in calls.items():
            turns[name].append({"ms": time_cuda(fn),
                                "device_ms": device_ms(fn, 50)})
    med = {name: {key: float(np.median([t[key] for t in ts]))
                  for key in ("ms", "device_ms")}
           for name, ts in turns.items()}
    miss = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in states_b["miss"].items()}
    plain_ms = time_cuda(lambda: select_rows_ref(
        *args_b, **miss, cache_out=miss["cache_ok"].clone(),
        cand_row=True), 10, 2)
    # least work with every block a miss: the uncached kernel's, and the
    # (k, R, n) candidate bytes written, hit_blk read and cand_row written
    k, R = src_order.shape[0], step.r_cap
    n = args_b[3]["used"].shape[0]
    nbytes = k1["bytes"] + k * R * n + k * R // step.rb + k * R
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(k1["f64_ops"] / F64_OPS_PER_S,
                 k1["int_ops"] / INT_OPS_PER_S) * 1e3
    out = {"card": card, "cases": cases, "max_abs_err": 0,
           "comparison": "bitwise: any, dst, cand_src, cand_row and the "
                         "written cache",
           "at": "cluster B's first step, every block a miss",
           "ms": med["miss"]["ms"], "device_ms": med["miss"]["device_ms"],
           "hit_ms": med["hit"]["ms"], "hit_device_ms":
               med["hit"]["device_ms"],
           "uncached_ms": med["uncached"]["ms"],
           "uncached_device_ms": med["uncached"]["device_ms"],
           "plain_ms": plain_ms, "library_ms": None,
           "library_device_ms": None, "turns": turns,
           "cache_bytes": k * R * n, "bytes": nbytes,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    emit("k1_cached", **out)
    return out


def optin_matrix() -> dict:
    """Cache x pipeline x source bounds at chunk 8 on two small clusters:
    the card's run equal to the CPU's, in moves, ``sources_tried`` and
    every counter, each under a tracer; ``select_rows`` once a step on the
    card, the cached instantiation exactly where the cache is on."""
    from repro_torch.core import clustergen
    from repro_torch.kernels import select_move
    runs = 0
    t0 = time.perf_counter()
    for cluster in ("small_test_cluster", "cluster_a"):
        base = getattr(clustergen, cluster)()
        for cache in (True, False):
            for pipeline in (True, False):
                for bounds in (True, False):
                    kw = dict(chunk=8, legality_cache=cache,
                              pipeline=pipeline, source_bounds=bounds)
                    want = counted(exact_copy(base), device="cpu", **kw)
                    select_move.reset_launch_count()
                    got = counted(exact_copy(base), device="cuda", **kw)
                    launches = select_move.launch_counts()["select_rows"]
                    runs += 1
                    want.pop("seconds"), got.pop("seconds")
                    check(got == want, f"{cluster} {kw}: the card's run "
                                       f"differs from the CPU's")
                    check(launches == 8 * got["chunks"]
                          and select_move.cached_launch_count()
                          == (launches if cache else 0),
                          f"{cluster} {kw}: K1 launches")
    return {"runs": runs, "identical": True,
            "seconds": time.perf_counter() - t0}


def optin_fuzz() -> dict:
    """The generated sweep of phase ``fuzz`` through ``equilibrium_batch``
    with the legality cache on the card, under a tracer: every oracle of
    the lane (legality, variance, conservation, one rebuild) and agreement
    in moves and metrics JSON with phase ``fuzz``'s faithful and dense
    lanes of the same timelines; ``select_rows`` once a step, all cached."""
    from repro_torch import obs
    from repro_torch.fuzz import OracleFailure
    from repro_torch.fuzz.harness import run_lifecycle
    from repro_torch.kernels import select_move
    from repro_torch.sim import generate_timeline
    reg = obs.registry()
    timelines = moves = steps = 0
    select_move.reset_launch_count()
    t0 = time.perf_counter()
    for profile, seeds in FUZZ_SWEEP:
        for seed in seeds:
            label = f"{profile} seed {seed}"
            tl = generate_timeline(seed, profile)
            state, events, cfg = tl.build("equilibrium_batch")
            snap = reg.snapshot("batch.chunks")
            with obs.tracing():
                try:
                    lane = run_lifecycle(state, events, cfg,
                                         "equilibrium_batch",
                                         planner_kwargs={
                                             "legality_cache": True})
                except OracleFailure as e:
                    fail(f"fuzz with the cache, {label}: {e}")
            chunks = int(reg.deltas_since(snap).get("batch.chunks", 0))
            steps += chunks * max(1, int(tl.sim["moves_per_tick"]))
            for engine, (want_moves, want_json) in FUZZ_LANES[label].items():
                check(lane.moves == want_moves
                      and lane.metrics_json == want_json,
                      f"fuzz with the cache, {label}: differs from phase "
                      f"fuzz's {engine} lane")
            timelines += 1
            moves += lane.planned_moves
    launches = select_move.launch_counts()
    check(launches == {"select_rows": steps, "masked_select": 0,
                       "select_rows_window": 0}
          and select_move.cached_launch_count() == steps and steps > 0,
          f"fuzz with the cache: K1 launched {launches} "
          f"({select_move.cached_launch_count()} cached) over {steps} steps")
    return {"timelines": timelines, "moves": moves, "steps": steps,
            "k1_launches": launches["select_rows"],
            "seconds": time.perf_counter() - t0}


def phase_batch_optins(card: str, base, k1: dict) -> dict:
    """The batch engine's opt-ins on the card: K1's cached instantiation
    (:func:`k1_cached`), the small-cluster matrix (:func:`optin_matrix`),
    cluster B to convergence with the cache on an exact copy of phase 3's
    cluster under a tracer (``planner.tail.B1x.batch-cache``'s moves,
    histogram and certificate counters, the reference engine's counters
    of ``tests/fixtures/batch_counters_cluster_b.json``, one host sync a
    chunk, ``select_rows`` once a step, every launch cached:
    :func:`check_cluster_b`), plan seconds with the cache and the
    pipeline on and off in turns, a profiled first chunk with the cache,
    and the fuzz sweep with the cache (:func:`optin_fuzz`)."""
    from repro_torch.kernels import select_move
    cached = k1_cached(card, base, k1)
    matrix = optin_matrix()
    emit("batch_optins_matrix", **matrix)

    ref = json.loads(REF_COUNTERS.read_text())
    want = ref["runs"]["legality_cache=True"]
    bench = bench_row("planner.tail.B1x.batch-cache")
    cfg = {k: v for k, v in ref["config"].items() if k != "source_block"}
    select_move.reset_launch_count()
    got = counted(exact_copy(base), legality_cache=True, device="cuda",
                  **cfg)
    steps = got["chunks"] * cfg["chunk"]
    run = check_cluster_b("with the cache", got, want, bench, steps, True)

    # plan seconds in turns, untraced: the defaults (no cache, pipelined),
    # the cache on, the pipeline off
    configs = {f"cache={c},pipeline={p}": dict(legality_cache=c, pipeline=p)
               for c, p in ((False, True), (True, True), (False, False))}
    secs = plan_turns(base, configs, OPTIN_TURNS, want["moves"])
    prof = profile_chunk(exact_copy(base), card, legality_cache=True)
    fz = optin_fuzz()
    out = {"card": card, "k1_cached": {k: v for k, v in cached.items()
                                       if k != "turns"},
           "matrix": matrix, "cluster_b": run,
           "plan_s_median": {name: float(np.median(v))
                             for name, v in secs.items()},
           "plan_s_turns": secs, "profile_with_cache": prof, "fuzz": fz}
    emit("batch_optins", **out)
    out["k1_cached_launches"] = steps
    return out


# ---------------------------------------------------------------------------
# phase source_block: the walk's source block above 1

#: the source blocks phase ``source_block`` plans cluster B at: 3 (25
#: sources in 9 blocks, the last padded to 27) and 25 (one block)
SOURCE_BLOCKS = (3, 25)
#: untraced plan-time turns per configuration of phase ``source_block``
#: (three before phase ``shard`` joined the run's time limit)
SOURCE_BLOCK_TURNS = 2


def k1_at_source_block(base, kb: int) -> dict:
    """K1 on the input the main path gives it at source block ``kb``: the
    ``k_pad`` positions, device 0 in the padding, and with the cache each
    tile's hit spread over its kb slots (``_Chunk.hits``).  Cluster B with
    the cache steps until a step has tiles that hit and tiles that miss:
    while the fullest source wins, its own block is walked and its move
    dirties it, so the first hits come where the walk reaches further, at
    the latest once the plan has converged (then nothing moves and the
    tiles walked stay clean).  At kb 25 the one block never hits in the
    reference's run, so its first step is taken.  That step's arguments
    go through the
    uncached kernel and the cached one, staged and from device memory,
    with the engine's hit mask and with a checkerboard of hit tiles, each
    bitwise against the plain version on the same inputs: any, dst,
    cand_src, cand_row and the cache written.  These launches are counted
    apart from the main path's."""
    from repro_torch.core.equilibrium_batch import BatchPlanner
    from repro_torch.kernels import select_move
    from repro_torch.kernels.ref import select_rows_ref
    planner = BatchPlanner(exact_copy(base), device="cuda", source_block=kb,
                           legality_cache=True)
    planner.sync()
    step = planner._step
    # cluster B converges in 839 steps
    for steps in range(1, (16 * planner.chunk if step.n_sb > 1 else 1) + 1):
        step.run(1)
        _, src_order, n_avail = step.sources()
        _, hit_pos, hit_tile = step.hits(src_order)
        mixed = bool(hit_tile.any()) and not bool(hit_tile.all())
        if mixed:
            break
    check(mixed or step.n_sb == 1,
          f"source_block {kb}: no step in {steps} has tiles that hit and "
          f"tiles that miss")
    pad = src_order[step.k:]
    check(src_order.shape[0] == step.k_pad == step.n_sb * step.kb
          and bool((pad == 0).all()),
          f"source_block {kb}: {src_order.shape[0]} positions, padding "
          f"{pad.tolist()}")
    args = (src_order, n_avail, step.cap_lim, step.dyn, step.const,
            step.scal)
    select_move.reset_launch_count()
    got = select_move.select_rows_fwd(*args, cand_row=True)
    want = select_rows_ref(*args, cand_row=True)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"select_rows at source_block {kb} differs from its plain version")
    nb = hit_tile.shape[1]
    blk = torch.arange(nb, device=hit_tile.device)
    checker = ((step.sb_iota[:, None] + blk[None, :]) % 2 == 0
               ).repeat_interleave(step.kb, dim=0)
    cases = 0
    for name, hit in (("engine", hit_pos), ("checkerboard", checker)):
        for limit in (None, 0):
            cases += 1
            cache = dict(cache_ok=step.dyn["c_ok"].clone(),
                         hit_blk=hit.contiguous(), rb=step.rb)
            check(cached_case(args, cache, limit),
                  f"cached select_rows at source_block {kb} differs from "
                  f"its plain version ({name} hits, smem_limit {limit})")
    launches = select_move.launch_counts()
    check(launches == {"select_rows": cases + 1, "masked_select": 0,
                       "select_rows_window": 0}
          and select_move.cached_launch_count() == cases,
          f"source_block {kb}: K1 checks launched {launches}")
    return {"k": step.k, "k_pad": step.k_pad, "steps_before": steps,
            "engine_hit_tiles": int(hit_tile.sum()),
            "tiles": hit_tile.numel(), "uncached_cases": 1,
            "cached_cases": cases, "max_abs_err": 0,
            "comparison": "bitwise: any, dst, cand_src, cand_row and the "
                          "written cache"}


def phase_source_block(card: str, base) -> dict:
    """Cluster B at source block 3 and 25.  K1 first, on the padded and
    tile-spread input those blocks give it (:func:`k1_at_source_block`).
    Then cluster B to convergence with the legality cache on and off,
    each on an exact copy of phase 3's cluster under a tracer, held by
    :func:`check_cluster_b` to ``planner.tail.B1x.batch`` and to the
    reference engine's run at that source block in
    ``tests/fixtures/batch_counters_cluster_b.json``; one chunk at each
    block with the cache and the telemetry on (the step's most
    operations) without a host sync; plan seconds of each run and of the
    default (source_block 1, no cache) in untraced turns."""
    from repro_torch.kernels import select_move
    ref = json.loads(REF_COUNTERS.read_text())
    bench = bench_row(BENCH_ROWS[1])
    cfg = {k: v for k, v in ref["config"].items() if k != "source_block"}
    k1_checks = {str(kb): k1_at_source_block(base, kb)
                 for kb in SOURCE_BLOCKS}
    runs = {}
    launches = {"select_rows": 0, "select_rows_cached": 0}
    for kb in SOURCE_BLOCKS:
        for cache in (True, False):
            key = f"source_block={kb},legality_cache={cache}"
            select_move.reset_launch_count()
            got = counted(exact_copy(base), legality_cache=cache,
                          source_block=kb, device="cuda", **cfg)
            steps = got["chunks"] * cfg["chunk"]
            runs[key] = check_cluster_b(key, got, ref["runs"][key], bench,
                                        steps, cache)
            launches["select_rows_cached" if cache else "select_rows"] += \
                steps
    no_sync = {}
    for kb in SOURCE_BLOCKS:
        _, no_sync[str(kb)] = chunk_without_sync(
            exact_copy(base), telemetry=True, source_block=kb,
            legality_cache=True)
        check(no_sync[str(kb)] > 0, f"cluster B at source_block {kb}: a "
                                    f"chunk emitted no move")

    # plan seconds in turns, untraced: the default, then each run
    configs = {"source_block=1,legality_cache=False": {}}
    configs.update({f"source_block={kb},legality_cache={cache}":
                    dict(source_block=kb, legality_cache=cache)
                    for kb in SOURCE_BLOCKS for cache in (True, False)})
    secs = plan_turns(base, configs, SOURCE_BLOCK_TURNS, bench["converged"])
    out = {"card": card, "k1_checks": k1_checks, "runs": runs,
           "no_sync_chunk_moves": no_sync,
           "plan_s_median": {name: float(np.median(v))
                             for name, v in secs.items()},
           "plan_s_turns": secs, "k1_launches": launches}
    emit("source_block", **out)
    return out


# ---------------------------------------------------------------------------
# phase fleet: the fleet planner (repro_torch.fleet), K1 with a lane axis

#: the cluster-B fleet: lanes, chunk and row block of its planner, the
#: row capacity every lane is pinned to so that all share one bucket, and
#: the growth of pool 0 that lane i takes first (i times this)
FLEET_LANES = 8
FLEET_CHUNK = 64
FLEET_RB = 8
FLEET_ROW_CAPACITY = 256
FLEET_GROWTH_TIB = 10
#: the paper fleet: the six clusters at their default seeds
PAPER_FLEET = ("cluster_a", "cluster_b", "cluster_c", "cluster_d",
               "cluster_e", "cluster_f")
#: the certificate and histogram stats a fleet lane is held to
FLEET_STAT_KEYS = ("bound_hits", "pruned_sources", "tail_moves",
                   "sources_tried_hist")


def fleet_states(plain: dict) -> list:
    """The cluster-B fleet's lanes: exact copies of the cluster whose
    ``to_plain()`` is ``plain``, lane i's pool 0 grown by i x
    :data:`FLEET_GROWTH_TIB` TiB first (the lifecycle timeline's growth),
    so that no two lanes plan alike."""
    from repro_torch.core import ClusterState, TiB
    lanes = []
    for i in range(FLEET_LANES):
        state = ClusterState.from_plain(plain)
        if i:
            state.grow_pool(0, i * FLEET_GROWTH_TIB * TiB)
        lanes.append(state)
    return lanes


def new_fleet(states: dict, row_capacity=None):
    """A fleet planner on the card with ``states`` (key: state) as its
    lanes, each synced (built) and packed: (planner, set-up seconds)."""
    from repro_torch.fleet import FleetPlanner
    fp = FleetPlanner(chunk=FLEET_CHUNK, row_block=FLEET_RB, device="cuda")
    t0 = time.perf_counter()
    for key, state in states.items():
        fp.add_cluster(key, state, row_capacity=row_capacity)
    for key in states:
        bp = fp._clusters[key]
        bp.sync()
        fp._pack.ensure(key, bp)
    torch.cuda.synchronize()
    return fp, time.perf_counter() - t0


def fleet_converge(fp, **kw) -> tuple:
    """Fleet ticks with every lane at its default budget until every lane
    has converged: (the per-lane moves, the last tick's results, the
    ticks, seconds)."""
    moves = {key: [] for key in fp.clusters}
    t0 = time.perf_counter()
    for ticks in range(1, 11):
        res = fp.plan_fleet(**kw)
        for key, r in res.items():
            moves[key] += as_tuples(r.moves)
        if all(r.stats["converged"] for r in res.values()):
            break
    torch.cuda.synchronize()
    return moves, res, ticks, time.perf_counter() - t0


class restored:
    """Runs a block on a bucket's stacked carry and puts the carry back
    as it was (in place, so the step's K1 binding stays valid): a profile,
    a sync check or an operation count of a live chunk that the plan
    does not see."""

    def __init__(self, bucket):
        self.bucket = bucket

    def __enter__(self):
        self.saved = {k: v.clone() for k, v in self.bucket.dyn.items()}

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            self.bucket.dyn[k].copy_(v)


def fleet_lane_k1(step, what: str, smem_limits=(None, 0)) -> tuple:
    """K1's lane launch on a bucket's step as the plan gives it, bitwise
    against the lane form of its plain version on the same inputs
    (any, dst, cand_src, cand_row), staged and from device memory: (the
    launches made, the largest |dst - plain dst| they gave)."""
    from repro_torch.kernels import select_move
    from repro_torch.kernels.ref import select_rows_lanes_ref
    _, src_order, n_avail = step.sources()
    want = select_rows_lanes_ref(src_order, n_avail, step.cap_lim, step.dyn,
                                 step.const, step.scal, cand_row=True)
    err = 0
    for limit in smem_limits:
        bound = select_move.SelectRows(step.cap_lim, step.dyn, step.const,
                                       step.scal, smem_limit=limit,
                                       lanes=True)
        got = bound(src_order, n_avail, cand_row=True)
        torch.cuda.synchronize()
        err = max(err, int((got[1] - want[1]).abs().max()))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"select_rows with a lane axis differs from its plain lane "
              f"form on {what} (smem_limit {limit})")
    return len(smem_limits), err


def fleet_k1_times(step, bp0, env: dict, max_abs_err: int) -> dict:
    """K1's lane launch at the cluster-B fleet's first step (8 lanes):
    kernel, plain and bound times, the bound counted from each lane's
    carry as :func:`select_rows_work` counts it and summed; beside it the
    one-carry launch of lane 0's serial planner at the same step, in
    turns, three each; ``max_abs_err``: :func:`fleet_lane_k1`'s."""
    from repro_torch.kernels import select_move
    from repro_torch.kernels.ref import (lane_view, select_rows_lanes_ref,
                                         select_rows_ref)
    _, src_order, n_avail = step.sources()
    lanes = select_move.SelectRows(step.cap_lim, step.dyn, step.const,
                                   step.scal, lanes=True)
    one = bp0._step
    _, src1, avail1 = one.sources()
    single = select_move.SelectRows(one.cap_lim, one.dyn, one.const,
                                    one.scal)
    turns = {"lanes_8": [], "lanes_1": []}
    for _ in range(3):
        for name, fn in (("lanes_8", lambda: lanes(src_order, n_avail)),
                         ("lanes_1", lambda: single(src1, avail1))):
            turns[name].append({"ms": time_cuda(fn),
                                "device_ms": device_ms(fn, 50)})
    med = {name: {key: float(np.median([t[key] for t in runs]))
                  for key in ("ms", "device_ms")}
           for name, runs in turns.items()}
    ins = env["k1_select_rows_instructions"]["staged"]
    div_ops = ins["dfma_per_division"][0] + 1
    work = [select_rows_work((src_order[i], n_avail[i], step.cap_lim[i],
                              lane_view(step.dyn, i),
                              lane_view(step.const, i),
                              lane_view(step.scal, i)), div_ops)
            for i in range(step.B)]
    f64 = sum(w["f64_ops"] for w in work)
    ints = sum(w["int_ops"] for w in work)
    nbytes = sum(w["bytes"] for w in work)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(f64 / F64_OPS_PER_S, ints / INT_OPS_PER_S) * 1e3
    plain_ms = time_cuda(lambda: select_rows_lanes_ref(
        src_order, n_avail, step.cap_lim, step.dyn, step.const, step.scal),
        10, 1)
    return {"at": "the cluster-B fleet's first step", "lanes": step.B,
            "shape": {"k": step.k, "R": step.r_cap,
                      "n": step.dev_iota.shape[0]},
            "ms": med["lanes_8"]["ms"],
            "device_ms": med["lanes_8"]["device_ms"],
            "plain_ms": plain_ms, "library_ms": None,
            "library_device_ms": None, "max_abs_err": max_abs_err,
            "f64_ops": f64, "int_ops": ints, "bytes": nbytes,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "lanes_1_at_lane_0": med["lanes_1"],
            "single_bound_ms": work[0]["bound_ms"], "turns": turns}


def fleet_step_ops(step, bucket, steps: int = 8) -> dict:
    """PyTorch operations a fleet step issues, untraced and traced,
    counted as ``tools/step_op_count.py`` counts the batch step (its
    ``OpCount``: non-view aten operations, K1's launch counted as one),
    on the live bucket, whose carry is put back after each count."""
    sys.path.insert(0, str(ROOT / "tools"))
    from step_op_count import OpCount
    from torch.utils._python_dispatch import _disable_current_modes
    fused = step.select_rows

    def one_launch(*args, **kwargs):
        with _disable_current_modes():
            return fused(*args, **kwargs)

    mask = torch.ones(len(bucket), dtype=torch.bool, device="cuda")
    out = {}
    step.select_rows = one_launch
    try:
        for traced in (False, True):
            with restored(bucket):
                counter = OpCount()
                with counter:
                    step.run(steps, mask, traced)
                torch.cuda.synchronize()
            out["traced" if traced else "untraced"] = counter.n / steps + 1
    finally:
        step.select_rows = fused
    return out


def profile_fleet_chunk(step, bucket, card: str) -> dict:
    """A profiled chunk of the live bucket (:func:`profiled`; its carry
    put back after, so the plan does not see it): device operations a
    step, busy seconds, idle share, K1's device time and the launches
    the profile recorded, which must be the chunk's every step."""
    mask = torch.ones(len(bucket), dtype=torch.bool, device="cuda")
    m = FLEET_CHUNK

    def run():
        step.run(m, mask)
        torch.cuda.synchronize()

    # a session the profiler lost records of is run again on the carry
    # the lost one left: the next chunk, as live
    with restored(bucket):
        rows, wall = profiled(
            run, lambda rows: None if matching(rows, K1_KERNEL)[1] == m
            else f"{matching(rows, K1_KERNEL)[1]} of {m} K1 launches",
            "a cluster-B fleet chunk")
    busy = sum(ms for ms, _ in rows.values()) / 1e3
    ops = sum(n for _, n in rows.values())
    k1_ms, k1_n = matching(rows, K1_KERNEL)
    return {"card": card, "chunk_steps": m, "lanes": step.B, "wall_s": wall,
            "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
            "device_ops": ops, "device_ops_per_step": ops / m,
            "k1_device_ms": k1_ms, "k1_calls_recorded": k1_n}


def check_fleet_run(what: str, reg, snap, launches: dict,
                    fleet_moves: dict) -> dict:
    """The counters of one fleet run: one round fetch a round, one
    ``select_rows`` launch a bucket step (the sum over its chunks of
    their steps), no ``masked_select``."""
    d = reg.deltas_since(snap)
    rounds, syncs = int(d.get("fleet.rounds", 0)), \
        int(d.get("fleet.round_syncs", 0))
    chunks = int(d.get("fleet.chunks", 0))
    check(rounds > 0 and syncs == rounds,
          f"{what}: {syncs} round fetches over {rounds} rounds")
    check(launches == {"select_rows": chunks * FLEET_CHUNK,
                       "masked_select": 0,
                       "select_rows_window": 0},
          f"{what}: K1 launched {launches} over {chunks} bucket chunks of "
          f"{FLEET_CHUNK} steps")
    return {"rounds": rounds, "round_syncs": syncs, "chunks": chunks,
            "overlapped_rounds": int(d.get("fleet.rounds.overlapped", 0)),
            "rebuckets": int(d.get("fleet.rebuckets", 0)),
            "k1_launches": launches["select_rows"],
            "moves": {str(k): len(v) for k, v in fleet_moves.items()}}


def serial_lane(state) -> tuple:
    """A serial ``BatchPlanner`` configured like a fleet lane, on the
    card, to convergence: (result, seconds)."""
    from repro_torch.core.planner import create_planner
    planner = create_planner("equilibrium_batch", chunk=FLEET_CHUNK,
                             row_block=FLEET_RB, source_block=1,
                             legality_cache=False, source_bounds=True,
                             device="cuda")
    t0 = time.perf_counter()
    res = planner.plan(state)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def same_lane(what: str, moves: list, stats: dict, want_moves: list,
              want_stats: dict) -> None:
    """A fleet lane's moves and :data:`FLEET_STAT_KEYS` against its serial
    planner's."""
    pairs = {k: (stats[k], want_stats[k]) for k in FLEET_STAT_KEYS[:2]}
    check(moves == want_moves
          and all(stats[k] == want_stats[k] for k in FLEET_STAT_KEYS),
          f"{what}: {len(moves)} fleet moves against {len(want_moves)} "
          f"serial; (fleet, serial) {pairs}")


def phase_fleet(card: str, base, full: dict, env: dict) -> dict:
    """The fleet planner on the card.  K1's lane launch first, bitwise
    against its plain lane form on the cluster-B fleet's first step and
    on the first step of each bucket of the paper fleet (padded devices,
    per-lane n_f), staged and from device memory.  Then the cluster-B
    fleet (:func:`fleet_states`, one bucket) to convergence: every lane
    equal to a serial planner configured like a lane on an exact copy
    (lane 0's is phase 3's plan, whose planner is configured so), lane 0
    also to ``planner.tail.B1x.batch``, one round
    fetch a round, one ``select_rows`` launch a bucket step, no host sync
    in a fleet chunk; its step's operations and a profiled chunk.  The 7
    other serial plans, then the cluster-B fleet again, its first tick
    cut by an SLO of 0.0 s (legal partial plans, then the uncut streams):
    the fleet's seconds in turns with the serial plans'.  The paper fleet
    (clusters A to F, B phase 3's) to convergence in co-scheduled rounds,
    each lane equal to its serial planner (B's: phase 3's plan).  The
    seconds each part took go out as ``part_s``."""
    from repro_torch import obs
    from repro_torch.core import ClusterState, clustergen
    from repro_torch.kernels import select_move
    reg = obs.registry()
    bench = bench_row(BENCH_ROWS[1])
    select_move.reset_launch_count()
    t_phase = time.perf_counter()
    part_s, t_part = {}, [t_phase]

    def lap(name: str) -> None:
        now = time.perf_counter()
        part_s[name] = now - t_part[0]
        t_part[0] = now

    # --- the cluster-B fleet, first turn: its first step's K1, the gates
    plain = base.to_plain()
    states = dict(enumerate(fleet_states(plain)))
    fp, setup_s = new_fleet(states, FLEET_ROW_CAPACITY)
    (shape, bucket), = fp._pack.buckets.items()
    check(len(bucket.lanes()) == FLEET_LANES,
          f"cluster-B fleet: {len(fp._pack.buckets)} buckets")
    step = fp._step_of(bucket)
    lap("cluster_b_fleet_setup")
    k1_checks, k1_err = fleet_lane_k1(step, "the cluster-B fleet's first "
                                            "step")
    k1 = fleet_k1_times(step, fp._clusters[0], env, k1_err)
    lap("k1")
    ops = fleet_step_ops(step, bucket)
    with restored(bucket):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = step.run(FLEET_CHUNK, torch.ones(
                FLEET_LANES, dtype=torch.bool, device="cuda"))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        no_sync_moves = int((out[:, :5 * FLEET_CHUNK].view(
            FLEET_LANES, -1, 5)[:, :, 0] >= 0).sum())
    check(no_sync_moves > 0, "cluster-B fleet: the sync-checked chunk "
                             "emitted no move")
    lap("step_ops_and_no_sync")
    prof = profile_fleet_chunk(step, bucket, card)
    lap("profile")
    select_move.reset_launch_count()
    snap = reg.snapshot()
    moves, res, ticks, plan_s = fleet_converge(fp)
    run = check_fleet_run("cluster-B fleet", reg, snap,
                          select_move.launch_counts(), moves)
    lane0 = res[0].stats
    hist = {int(k): v for k, v in lane0["sources_tried_hist"].items()}
    check(moves[0] == full["move_list"] and len(moves[0])
          == bench["converged"] and hist == bench["tried_hist"]
          and lane0["bound_hits"] == bench["bound_hits"]
          and lane0["pruned_sources"] == bench["pruned_sources"],
          f"cluster-B fleet lane 0: {len(moves[0])} moves, bound_hits "
          f"{lane0['bound_hits']}, pruned {lane0['pruned_sources']}")
    check(len({len(m) for m in moves.values()}) > 1
          or len({tuple(m[-1]) for m in moves.values()}) > 1,
          "cluster-B fleet: the lanes planned alike")
    # stats are per tick; one tick converged every lane
    check(ticks == 1, f"cluster-B fleet: {ticks} ticks to convergence")
    fleet_stats = {k: r.stats for k, r in res.items()}
    same_lane("cluster-B fleet lane 0", moves[0], fleet_stats[0],
              full["move_list"], full["stats"])
    lap("cluster_b_fleet_plan")

    # --- the serial plans of lanes 1 to 7 (the comparators; lane 0's is
    # phase 3's plan), then the fleet again
    serial_s = [full["plan_s"]]
    for i, state in enumerate(fleet_states(plain)[1:], 1):
        want, secs = serial_lane(state)
        serial_s.append(secs)
        same_lane(f"cluster-B fleet lane {i}", moves[i], fleet_stats[i],
                  as_tuples(want.moves), want.stats)
    lap("serial_plans")
    # --- the fleet again, its first tick cut by an SLO of 0.0 s: legal
    # partial plans, and on to convergence the uncut run's streams
    states2 = dict(enumerate(fleet_states(plain)))
    pre = dict(enumerate(fleet_states(plain)))
    t0 = time.perf_counter()
    fp2, setup2_s = new_fleet(states2, FLEET_ROW_CAPACITY)
    t1 = time.perf_counter()
    cut = fp2.plan_fleet(slo_seconds=0.0)
    rest, _, _, _ = fleet_converge(fp2)
    plan2_s = time.perf_counter() - t1
    fleet2_s = time.perf_counter() - t0
    replayed = 0
    for key, r in cut.items():
        check(r.stats["slo_expired"] and 0 < len(r.moves) < len(moves[key]),
              f"SLO-cut tick, lane {key}: {len(r.moves)} moves, expired "
              f"{r.stats['slo_expired']}")
        for mv in r.moves:
            check(pre[key].move_is_legal(mv.pg, mv.slot, mv.dst_osd),
                  f"SLO-cut tick, lane {key}: illegal move {mv}")
            pre[key].apply(mv)
            replayed += 1
    check(all(as_tuples(cut[k].moves) + rest[k] == moves[k] for k in moves),
          "SLO-cut tick: the cut stream and its continuation differ from "
          "the uncut run")
    lap("slo_cut_fleet")

    # --- the paper fleet: six clusters, several buckets
    paper = {name: (ClusterState.from_plain(plain) if name == "cluster_b"
                    else getattr(clustergen, name)())
             for name in PAPER_FLEET}
    # cluster B's serial plan is phase 3's
    twins = {name: exact_copy(s) for name, s in paper.items()
             if name != "cluster_b"}
    lap("paper_clusters")
    fpp, paper_setup_s = new_fleet(paper)
    padded = 0
    for shp, bkt in fpp._pack.buckets.items():
        real = [bkt.dims[i].n_dev for i in bkt.lanes().values()]
        padded += sum(n < shp.n_dev for n in real)
        n_checks, err = fleet_lane_k1(fpp._step_of(bkt),
                                      f"the paper fleet's bucket of {real} "
                                      f"devices padded to {shp.n_dev}")
        k1_checks += n_checks
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
    check(padded > 0 and len(fpp._pack.buckets) > 1,
          f"paper fleet: {len(fpp._pack.buckets)} buckets, {padded} "
          f"padded lanes")
    select_move.reset_launch_count()
    snap = reg.snapshot()
    pmoves, pres, pticks, paper_s = fleet_converge(fpp)
    prun = check_fleet_run("paper fleet", reg, snap,
                           select_move.launch_counts(), pmoves)
    check(prun["overlapped_rounds"] > 0,
          "paper fleet: no co-scheduled round")
    check(pticks == 1, f"paper fleet: {pticks} ticks to convergence")
    same_lane("paper fleet cluster_b", pmoves["cluster_b"],
              pres["cluster_b"].stats, full["move_list"], full["stats"])
    lap("paper_fleet_plan")
    paper_serial_s = {"cluster_b": full["plan_s"]}
    for name, state in twins.items():
        want, paper_serial_s[name] = serial_lane(state)
        same_lane(f"paper fleet {name}", pmoves[name], pres[name].stats,
                  as_tuples(want.moves), want.stats)
    lap("paper_serial_plans")

    out = {"card": card,
           "k1": {"lane_checks": k1_checks, **k1},
           "cluster_b_fleet": {
               "lanes": FLEET_LANES, "chunk": FLEET_CHUNK,
               "row_capacity": FLEET_ROW_CAPACITY,
               "bucket": dataclasses.asdict(shape),
               **run, "ticks": ticks, "setup_s": setup_s, "plan_s": plan_s,
               "seconds": setup_s + plan_s,
               "second_run": {"setup_s": setup2_s, "plan_s": plan2_s,
                              "seconds": fleet2_s,
                              "first_tick_slo_seconds": 0.0},
               "serial_seconds": serial_s,
               "serial_seconds_sum": sum(serial_s),
               "no_sync_chunk_moves": no_sync_moves,
               "step_ops": ops, "profile": prof},
           "slo_cut": {"moves_in_cut_tick": {str(k): len(r.moves)
                                             for k, r in cut.items()},
                       "replayed_legal": replayed},
           "paper_fleet": {
               "buckets": [{"n_dev": s.n_dev, "r_cap": s.r_cap,
                            "lanes": sorted(b.lanes())}
                           for s, b in fpp._pack.buckets.items()],
               "padded_lanes": padded, **prun, "ticks": pticks,
               "setup_s": paper_setup_s, "plan_s": paper_s,
               "serial_seconds": paper_serial_s},
           "part_s": part_s, "seconds": time.perf_counter() - t_phase}
    emit("fleet", **out)
    return out


# ---------------------------------------------------------------------------
# phase shard: the sharded batch engine (``repro_torch.core.shard``) in an
# NCCL group of one rank, and K1's window form

#: the splits of the device axis K1's window form is held to its plain
#: version at
SHARD_WAYS = (1, 2, 4)


def window_bytes(wargs: tuple) -> int:
    """The bytes K1's window form must move: the window's (n,) device
    vectors, the source side's (n,) vectors at the sources, its
    destination-count block read once, each gathered row's entries once
    (row id, packed record, acting set, criterion), the outputs written
    once."""
    src_order, _, rows_k, _, act_k, _, _, dyn, const, _ = wargs
    k, R = rows_k.shape
    S, L = act_k.shape[2], const["dev_domain"].shape[0]
    P, n_local = dyn["dst_ok"].shape
    return (n_local * (5 * 8 + 1 + 8 * L) + P * n_local + 3 * 8 * k
            + k * R * (8 + 8 * 8 + 8 * S + 1) + k * R * 5 + 9 * k)


def shard_window_k1(args_b: tuple, div_ops: int) -> dict:
    """K1's window form at cluster B's first step: every window of the
    device axis split :data:`SHARD_WAYS` ways, staged and from device
    memory, bitwise against ``select_rows_window_ref`` (any, global dst,
    cand_src, cand_row); each split's windows, launched with every
    position available and folded as the engine folds its ranks
    (``shard_winner_better``, then the parked positions masked), equal to
    one unwindowed ``select_rows`` launch; the whole axis's window (one
    rank's) timed, its bound counted from the data."""
    from _select_rows_carries import fold_windows, window_args
    from repro_torch.kernels import select_move
    from repro_torch.kernels.ref import select_rows_window_ref
    select_move.reset_launch_count()
    unwindowed = select_move.select_rows_fwd(*args_b)
    k = args_b[0].shape[0]
    every = torch.full((), k, device="cuda")
    avail = torch.arange(k, device="cuda") < args_b[1]
    worst, cases, folds = 0, 0, 0
    for ways in SHARD_WAYS:
        for limit in (None, 0):
            outs = []
            for rank in range(ways):
                wargs, base = window_args(args_b, ways, rank)
                bound = select_move.SelectRowsWindow(*wargs[6:], base,
                                                     smem_limit=limit)
                got = bound(*wargs[:6], cand_row=True)
                want = select_rows_window_ref(*wargs, base=base,
                                              cand_row=True)
                torch.cuda.synchronize()
                err = int((got[1].long() - want[1].long()).abs().max())
                worst = max(worst, err)
                cases += 1
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"K1's window form differs from its plain version at "
                      f"window {rank} of {ways} (smem_limit {limit}; max "
                      f"|dst diff| {err})")
                outs.append((*bound(wargs[0], every, *wargs[2:6]),
                             wargs[7]["util"]))
            folded = fold_windows(outs, avail)
            folds += 1
            check(all(torch.equal(g, w) for g, w in zip(folded, unwindowed)),
                  f"K1's {ways} windows folded (smem_limit {limit}) differ "
                  f"from one unwindowed select_rows launch")
    launches = select_move.launch_counts()
    check(launches == {"select_rows": 1, "masked_select": 0,
                        "select_rows_window": 2 * cases},
          f"K1's window checks launched {launches}")
    # the whole device axis as one window: world 1's launch
    wargs, base = window_args(args_b, 1, 0)
    times = {}
    for name, limit in (("staged", None), ("device_memory", 0)):
        bound = select_move.SelectRowsWindow(*wargs[6:], base,
                                             smem_limit=limit)
        times[name] = {"ms": time_cuda(lambda: bound(*wargs[:6])),
                       "device_ms": device_ms(lambda: bound(*wargs[:6]),
                                              50)}
    plain_ms = time_cuda(lambda: select_rows_window_ref(*wargs, base=base),
                         20, 2)
    work = select_rows_work(args_b, div_ops)
    nbytes = window_bytes(wargs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(work["f64_ops"] / F64_OPS_PER_S,
                 work["int_ops"] / INT_OPS_PER_S) * 1e3
    return {"at": "cluster B's first step, the whole device axis as one "
                  "window (world 1)",
            "windows_checked": cases, "folds_checked": folds,
            "max_abs_err": worst,
            "comparison": "bitwise: any, dst, cand_src and cand_row; the "
                          "folded windows against one select_rows launch",
            "ms": times["staged"]["ms"],
            "device_ms": times["staged"]["device_ms"],
            "device_memory": times["device_memory"],
            "plain_ms": plain_ms, "library_ms": None,
            "library_device_ms": None,
            "library": "none: no single PyTorch call computes the selection",
            **{key: work[key] for key in (
                "shape", "live_pairs", "pairs_to_slot_tests",
                "candidate_pairs", "legal_pairs", "f64_ops", "int_ops")},
            "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "launches_counted_apart": launches}


def sharded_plan(state, **options) -> tuple:
    """A cold plan of ``state`` to convergence with
    ``equilibrium_batch_sharded`` on the card: (the result, its seconds,
    the registry's deltas, K1's launches)."""
    from repro_torch import obs
    from repro_torch.core.planner import create_planner
    from repro_torch.kernels import select_move
    planner = create_planner("equilibrium_batch_sharded", device="cuda",
                             **options)
    reg = obs.registry()
    torch.cuda.synchronize()
    snap = reg.snapshot()
    select_move.reset_launch_count()
    t0 = time.perf_counter()
    res = planner.plan(state, record_trajectory=True, record_free_space=False)
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, reg.deltas_since(snap),
            select_move.launch_counts())


def phase_shard(card: str, base, full: dict, env: dict) -> dict:
    """The sharded batch engine in an NCCL process group of one rank, made
    in this process with a ``file://`` store: K1's window form
    (:func:`shard_window_k1`); ``cluster_b(scale=1)`` planned by
    ``equilibrium_batch_sharded`` to convergence on an exact copy, its
    moves, variances, sources tried and certificate counters phase 3's
    serial plan's, its ``batch.*`` counters phase 3's, one window launch
    a step and no unwindowed ``select_rows``, one host sync a chunk; one
    sharded chunk under ``torch.cuda.set_sync_debug_mode("error")``; the
    PyTorch operations and collectives a step (``tools/step_op_count.py``
    on the card); a profiled sharded chunk; the serial engine's plan
    seconds right after the sharded plan's."""
    import tempfile

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "tests"))
    sys.path.insert(0, str(ROOT / "tools"))
    from repro_torch.core.equilibrium_batch import BatchPlanner
    from repro_torch.core.planner import create_planner
    from repro_torch.core.shard import ShardedBatchPlanner
    from step_op_count import count
    t_phase = time.perf_counter()
    ins = env["k1_select_rows_instructions"]["window_staged"]
    planner = BatchPlanner(exact_copy(base), device="cuda")
    planner.sync()
    _, src_order, n_avail = planner._step.sources()
    step = planner._step
    args_b = (src_order, n_avail, step.cap_lim, step.dyn, step.const,
              step.scal)
    k1w = shard_window_k1(args_b, ins["dfma_per_division"][0] + 1)
    emit("shard_k1", card=card, **k1w)

    tmp = tempfile.TemporaryDirectory(prefix="shard-")
    dist.init_process_group("nccl", init_method=f"file://{tmp.name}/store",
                            world_size=1, rank=0)
    try:
        res, plan_s, d, launches = sharded_plan(exact_copy(base))
        st = res.stats
        chunks = int(d.get("batch.chunks", 0))
        repads = int(d.get("batch.repads", 0))
        steps = chunks * 64
        check(as_tuples(res.moves) == full["move_list"]
              and {k: st[k] for k in FLEET_STAT_KEYS} == full["stats"],
              f"cluster B sharded: {len(res.moves)} moves, "
              f"{ {k: st[k] for k in FLEET_STAT_KEYS} }; phase 3's "
              f"{len(full['move_list'])} and {full['stats']}")
        check([r.variance_after for r in res.records]
              == full["variance_trajectory"]
              and [r.sources_tried for r in res.records]
              == full["sources_tried"],
              "cluster B sharded: the variances or sources tried differ "
              "from phase 3's")
        counters = {k: int(v) for k, v in d.items() if k.startswith("batch.")}
        check(counters == full["batch_counters"],
              f"cluster B sharded: batch counters {counters}, phase 3's "
              f"{full['batch_counters']}")
        check(st["shards"] == 1 and st["host_syncs"] == chunks + repads,
              f"cluster B sharded: {st['shards']} shards, {st['host_syncs']}"
              f" host syncs over {chunks} chunks and {repads} re-pads")
        check(launches == {"select_rows": 0, "masked_select": 0,
                           "select_rows_window": steps},
              f"cluster B sharded: K1 launched {launches} over {steps} "
              f"steps")

        bp = ShardedBatchPlanner(exact_copy(base), device="cuda")
        bp.sync()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = bp._step.run(bp.chunk)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        no_sync_moves = int((out[:5 * bp.chunk].view(-1, 5)[:, 0] >= 0)
                            .sum())
        check(no_sync_moves > 0, "the sharded chunk emitted no move")
        ops = {"sharded": count(None, 8, planner=ShardedBatchPlanner(
                   exact_copy(base), device="cuda")),
               "serial": count(None, 8, planner=BatchPlanner(
                   exact_copy(base), device="cuda"))}
        prof = profile_chunk(exact_copy(base), card,
                             engine=ShardedBatchPlanner,
                             kernel="select_rows_window_kernel")

        # the serial engine's plan right after the gated sharded one
        serial_planner = create_planner("equilibrium_batch", device="cuda")
        state = exact_copy(base)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = serial_planner.plan(state, record_free_space=False)
        torch.cuda.synchronize()
        serial = time.perf_counter() - t0
        check(len(got.moves) == len(full["move_list"]),
              f"the serial plan beside phase shard: {len(got.moves)} moves")
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    sharded = plan_s
    out = {"card": card, "world_size": 1, "backend": "nccl",
           "moves": len(res.moves), "plan_s": plan_s,
           "chunks": chunks, "repads": repads,
           "host_syncs": st["host_syncs"],
           "bound_hits": st["bound_hits"],
           "pruned_sources": st["pruned_sources"],
           "k1_launches": launches, "batch_counters": counters,
           "no_sync_chunk_moves": no_sync_moves,
           "step_ops": ops, "profile": prof,
           "serial_s": serial, "sharded_s": sharded,
           "sharded_over_serial": sharded / serial,
           "seconds": time.perf_counter() - t_phase}
    emit("shard", **out)
    out["k1"] = k1w
    return out


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
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.models import prefill
    torch.backends.cuda.matmul.allow_tf32 = False    # full float32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, on_card, on_cpu = card_and_cpu_models(arch, n_layers)
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


#: decode against prefill (phase ``serve``, (b)): the 6-layer zamba2 in
#: float32, 64 decode steps' last logits against the prefill's, which
#: reach them by K2's flash softmax and K3's chunked scan instead of the
#: direct product and the one-token recurrence; the same rtol = atol as
#: the card against the CPU (PERF.md §6 has the measured gap)
DECODE_PREFILL_TOL = 1e-3
#: decode parity, card against CPU (phase ``serve``, (a)): architecture,
#: layers kept, and the K2 / K3 launches of the decode path (none)
SERVE_PARITY = (("zamba2-7b", 6), ("mamba2-2.7b", 4), ("qwen3-0.6b", 2))
#: the full-depth zamba2-7b serving run (phase ``serve``, (c))
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_REQUESTS, SERVE_NEW_TOKENS = 4, 256, 8, 32
SERVE_REBALANCE_EVERY = 8


def card_and_cpu_models(arch: str, n_layers: int) -> tuple:
    """``arch`` at full width cut to ``n_layers``, float32, seed 0 on the
    card and a copy of its parameters on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM, build_model
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype="float32")
    on_card = build_model(cfg, seed=0)
    on_cpu = LM(cfg, torch.device("cpu"))
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    return cfg, on_card, on_cpu


def decode_parity(arch: str, n_layers: int, steps: int = 16,
                  B: int = 2) -> tuple[dict, object]:
    """(a): ``steps`` decode steps from an empty cache on the card and on
    the CPU, every step's logits within 1e-3, no K2 or K3 launch.
    Returns the line's fields and the card's model."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.models import decode_step, init_cache
    t0 = time.perf_counter()
    cfg, on_card, on_cpu = card_and_cpu_models(arch, n_layers)
    setup_s = time.perf_counter() - t0
    card_cache = init_cache(cfg, B, steps, "cuda")
    cpu_cache = init_cache(cfg, B, steps, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (steps, B, 1)))
    k2.reset_launch_count()
    k3.reset_launch_count()
    errs, scale = [], 0.0
    for i, tok in enumerate(tokens):
        got, card_cache = decode_step(on_card, card_cache, tok.cuda())
        want, cpu_cache = decode_step(on_cpu, cpu_cache, tok)
        got = got.cpu()
        errs.append(float((got - want).abs().max()))
        scale = max(scale, float(want.abs().max()))
        check(bool(torch.isfinite(got).all()), f"{arch} decode step {i}: "
                                               f"logits not finite")
        check(torch.allclose(got, want, rtol=1e-3, atol=1e-3),
              f"{arch} {n_layers}-layer decode step {i}: card differs "
              f"from CPU (max abs err {errs[-1]})")
    launches = (k2.launch_count(), k3.launch_count())
    check(launches == (0, 0), f"{arch} decode launched K2, K3 {launches} "
                              f"times, expected none")
    return ({"config": f"{arch}, n_layers {n_layers}, float32", "B": B,
             "steps": steps, "max_abs_err": max(errs),
             "max_abs_err_by_step": errs, "logit_scale": scale,
             "tolerance": "rtol = atol = 1e-3", "setup_s": setup_s},
            on_card)


def decode_against_prefill(model, T: int = 64) -> dict:
    """(b): ``T`` teacher-forced decode steps (B 1) against ``prefill``
    of the same tokens, both on the card; the prefill through K2 and K3
    (1 and 6 SIMT launches on the 6-layer zamba2 in float32)."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.models import decode_step, init_cache, prefill
    cfg = model.cfg
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, T))).cuda()
    cache = init_cache(cfg, 1, T, "cuda")
    for t in range(T):
        logits, cache = decode_step(model, cache, tokens[:, t:t + 1])
    k2.reset_launch_count()
    k3.reset_launch_count()
    want = prefill(model, {"tokens": tokens})
    launches = (k2.launch_counts(), k3.launch_counts())
    err = float((logits - want).abs().max())
    check(launches == ({"tensor_core": 0, "simt": 1},
                       {"tensor_core": 0, "simt": cfg.n_layers}),
          f"the decode-against-prefill prefill launched K2, K3 by variant "
          f"{launches}, expected 1 and {cfg.n_layers} SIMT")
    check(torch.allclose(logits, want, rtol=DECODE_PREFILL_TOL,
                         atol=DECODE_PREFILL_TOL),
          f"{T} decode steps differ from the prefill (max abs err {err})")
    return {"config": f"{cfg.name}, n_layers {cfg.n_layers}, float32",
            "T": T, "max_abs_err": err,
            "logit_scale": float(want.abs().max()),
            "tolerance": f"rtol = atol = {DECODE_PREFILL_TOL}",
            "prefill_launches_by_variant": {"k2": launches[0],
                                            "k3": launches[1]}}


def serve_zamba2(card: str) -> dict:
    """(c): the full-depth zamba2-7b ``ServeEngine`` run, which launches
    no K1 (the pool plans on the host dense lane), K2 or K3."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import select_move as k1
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.models import build_model, param_count
    from repro_torch.serve import (PagedKVPool, PagedKVSpec, Request,
                                   ServeEngine)
    sys.path.insert(0, str(ROOT / "tools"))
    from step_op_count import OpCount
    cfg = get_config("zamba2-7b")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pool = PagedKVPool(PagedKVSpec(n_chips=4, page_tokens=16,
                                   pages_per_chip=64))
    engine = ServeEngine(cfg, model, batch_slots=SERVE_SLOTS,
                         max_len=SERVE_MAX_LEN, pool=pool,
                         rebalance_every=SERVE_REBALANCE_EVERY)
    rng = np.random.default_rng(0)
    reqs = [Request(id=i, prompt=rng.integers(1, cfg.vocab_size,
                                              size=int(rng.integers(8, 25))),
                    max_new_tokens=SERVE_NEW_TOKENS)
            for i in range(SERVE_REQUESTS)]
    for r in reqs:
        engine.submit(r)
    # the sizes: every decode call advances the one shared len; the
    # prompts' calls plus one a step must stay below max_len
    prompt_tokens = sum(len(r.prompt) for r in reqs)

    plans = []
    rebalance = pool.rebalance

    def recorded(*args):
        live = len(pool.seq_chip)
        plan = rebalance(*args)
        plans.append({"step": engine.steps, "live_sequences": live,
                      "chips_used": sorted(set(pool.seq_chip.values())),
                      "moves": len(plan),
                      "bytes": pool.migration_bytes(plan)})
        return plan
    pool.rebalance = recorded

    calls = [0]
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    decode = engine._decode

    def counted(tokens):
        nonlocal finite
        calls[0] += 1
        logits = decode(tokens)
        finite = finite & torch.isfinite(logits).all()
        return logits
    engine._decode = counted

    for kernel in (k1, k2, k3):
        kernel.reset_launch_count()
    torch.cuda.reset_peak_memory_stats()
    step_ms, admit_ms = [], []
    t_run = time.perf_counter()
    while engine.queue or engine.active:
        before = calls[0]
        t0 = time.perf_counter()
        engine.step()                         # ends in the argmax fetch
        ms = (time.perf_counter() - t0) * 1e3
        (step_ms if calls[0] - before == 1 else admit_ms).append(ms)
        check(engine.steps < 10 * SERVE_REQUESTS * SERVE_NEW_TOKENS,
              "the serving run does not finish")
    run_s = time.perf_counter() - t_run
    peak = torch.cuda.max_memory_allocated()
    final_len = engine.cache["len"]
    tokens = sum(len(r.generated) for r in reqs)
    live_plans = [p for p in plans if p["live_sequences"]]
    launches = [kernel.launch_count() for kernel in (k1, k2, k3)]
    check(launches == [0, 0, 0], f"serving launched K1, K2, K3 {launches} "
                                 f"times, expected none")
    check(all(len(r.generated) == SERVE_NEW_TOKENS for r in reqs),
          f"serving: generated {[len(r.generated) for r in reqs]} tokens, "
          f"expected {SERVE_NEW_TOKENS} each")
    check(bool(finite), "serving: a decode call's logits were not finite")
    check(final_len == prompt_tokens + engine.steps
          and final_len < SERVE_MAX_LEN,
          f"serving: len {final_len} (prompt tokens {prompt_tokens} + "
          f"{engine.steps} steps), max_len {SERVE_MAX_LEN}")
    check(len(live_plans) >= 2, f"serving: {len(live_plans)} rebalances "
                                f"saw live sequences, expected 2 or more")
    why = None if any(p["moves"] for p in plans) else (
        "every rebalance found one sequence a chip (4 slots on 4 chips, "
        "admitted to the emptiest chip), so any move raises the variance")
    pool.rebalance = rebalance
    engine._decode = decode

    # one decode step counted and one profiled, on the engine after the
    # run (its cache advances by two more calls)
    batch = np.ones((SERVE_SLOTS, 1), np.int64)
    counter = OpCount()
    with counter:
        engine._decode(batch)
    torch.cuda.synchronize()

    def run():
        engine._decode(batch)
        torch.cuda.synchronize()
    rows, wall = profiled(run, lambda rows: None if rows
                          else "no device records", "a zamba2-7b decode step")
    busy = sum(ms for ms, _ in rows.values())
    top = sorted(((k, ms, n) for k, (ms, n) in rows.items()),
                 key=lambda r: -r[1])[:10]
    ordered = sorted(step_ms)
    out = {"card": card, "config": f"{cfg.name}, {cfg.n_layers} layers, "
                                   f"full width",
           "params": sum(p.numel() for p in model.parameters()),
           "param_count_analytic": param_count(cfg),
           "dtype": "bfloat16 compute, float32 parameters",
           "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
           "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW_TOKENS,
           "prompt_tokens": prompt_tokens,
           "prompt_lens": [len(r.prompt) for r in reqs],
           "pool": "4 chips, 16-token pages, 64 pages a chip",
           "rebalance_every": SERVE_REBALANCE_EVERY, "init_s": init_s,
           "steps": engine.steps, "decode_calls": calls[0],
           "tokens_generated": tokens, "run_s": run_s,
           "tokens_per_s": tokens / run_s,
           "decode_step_ms": {"steps": len(step_ms),
                              "median": ordered[len(ordered) // 2],
                              "min": ordered[0], "max": ordered[-1]},
           "admit_step_ms": admit_ms,
           "len_final": final_len, "len_bound": "prompt tokens + steps",
           "peak_mem_bytes": peak, "migrated_bytes": engine.migrated_bytes,
           "rebalances": plans, "rebalances_live": len(live_plans),
           "no_move_why": why,
           "pool_utilization": pool.utilization().tolist(),
           "ops_per_decode_step": counter.n,
           "profile": {"wall_ms": wall * 1e3, "device_ms": busy,
                       "idle_share": 1.0 - busy / (wall * 1e3),
                       "device_ops": sum(n for _, n in rows.values()),
                       "top": [{"name": k[:80], "device_ms": ms,
                                "launches": n} for k, ms, n in top]}}
    del engine, model
    torch.cuda.empty_cache()
    return out


def phase_serve(card: str) -> dict:
    """Phase ``serve``: (a), (b) and (c) of the module docstring."""
    torch.backends.cuda.matmul.allow_tf32 = False    # full float32
    torch.backends.cudnn.allow_tf32 = False
    parity = {}
    for arch, n_layers in SERVE_PARITY:
        parity[arch], on_card = decode_parity(arch, n_layers)
        if arch == "zamba2-7b":
            against = decode_against_prefill(on_card)
        del on_card
        torch.cuda.empty_cache()
    out = {"card": card, "decode_parity": parity,
           "decode_against_prefill": against, "serve": serve_zamba2(card)}
    emit("serve", **out)
    return out


# ---------------------------------------------------------------------------
# phase train


#: phase ``train`` (d): qwen3-0.6b at full width and depth through the
#: training launcher, the registry's ``train_4k`` (S 4,096, global batch
#: 256) cut to B 4 for one card and the run's time limit; a first run of
#: :data:`TRAIN_QWEN3_STEPS` steps saving every :data:`TRAIN_SAVE_EVERY`,
#: then a restart from the checkpoint at that step to the same end
TRAIN_QWEN3_B, TRAIN_QWEN3_STEPS, TRAIN_SAVE_EVERY = 4, 4, 2
#: (e): mamba2-2.7b at full width and depth, B 1, microbatches 1
TRAIN_MAMBA2_B, TRAIN_MAMBA2_STEPS = 1, 3
TRAIN_S = 4096
#: (c): architectures and the layers kept for the card against the CPU
TRAIN_PARITY = (("zamba2-7b", 6), ("mamba2-2.7b", 4), ("qwen3-0.6b", 2))
#: (d): the restarted run's losses against the first run's: the two runs
#: differ only by the order of floating-point atomic additions (the
#: embedding's backward and the GEMMs' split reductions), which the bf16
#: gradients round differently
TRAIN_RESUME_TOL = 1e-3
#: the autograd nodes of the plain backwards (phase ``train``'s profiles)
PLAIN_BACKWARDS = ("FlashAttentionBackward", "SSDScanBackward")


def train_lse(card: str) -> dict:
    """(a): K2's log-sum-exp against the plain online version's on float32
    copies of the same bf16 inputs: at the zamba2 shape (Dh 112, the
    tensor-core variant) and at Dh 160 (the SIMT variant), causal, with a
    window and a softcap; the output unchanged beside it."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels.ref import flash_attention_online
    cases = {"zamba2_causal": (4096, 32, 112, None, None),
             "zamba2_window_softcap": (4096, 32, 112, 1024, 50.0),
             "dh160_causal": (2048, 8, 160, None, None),
             "dh160_window_softcap": (2048, 8, 160, 512, 50.0)}
    g = torch.Generator(device="cuda").manual_seed(30)
    out = {}
    for name, (T, H, Dh, window, cap) in cases.items():
        q, k, v = (torch.randn((1, T, H, Dh), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        kw = dict(causal=True, window=window, cap=cap)
        o, lse = k2.flash_attention_fwd(q, k, v, with_lse=True, **kw)
        check(torch.equal(o, k2.flash_attention_fwd(q, k, v, **kw)),
              f"K2 {name}: the output with the lse differs from without")
        _, want = flash_attention_online(q.float(), k.float(), v.float(),
                                         with_lse=True, **kw)
        err = float((lse - want).abs().max())
        check(err <= 2e-3, f"K2 {name}: lse max abs err {err} > 2e-3")
        out[name] = {"variant": k2.route(q.dtype, Dh), "T": T, "H": H,
                     "Dh": Dh, "window": window, "cap": cap,
                     "max_abs_err": err,
                     "lse_range": [float(want.min()), float(want.max())]}
        del q, k, v, o, lse, want
    torch.cuda.empty_cache()
    return {"cases": out, "tolerance": "2e-3 absolute (bf16 inputs)"}


def train_grads(card: str) -> dict:
    """(b): the backward passes at a qwen3 layer's attention (B 1, T
    4,096, H 16 over KV 8, Dh 128) and a mamba2 layer's scan (B 1, T
    4,096, H 80, P 64, N 128, chunk 128, the model's ramps), bf16 inputs
    that require a gradient: through K2 / K3 forwards against the
    all-plain path on the card.  Attention within 2e-2 of each
    gradient's largest entry (K2's bf16 ``out`` in ``delta``).  The scan's
    forward through K3 within :data:`ROW_REL_TOL` of the float32 plain
    version in every (token, head) row; its gradients equal the all-plain
    ones, which checks the backward's plain recompute from the saved
    inputs, not K3 (the backward never reads K3's output)."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.kernels.ref import (flash_attention_bwd_plain,
                                         flash_attention_online, ssd_chunked)
    g = torch.Generator(device="cuda").manual_seed(31)
    q, k, v = (torch.randn((1, TRAIN_S, h, 128), generator=g, device="cuda")
               .to(torch.bfloat16).requires_grad_() for h in (16, 8, 8))
    dout = torch.randn((1, TRAIN_S, 16, 128), generator=g,
                       device="cuda").to(torch.bfloat16)
    k2.reset_launch_count()
    got = torch.autograd.grad(ops.flash_attention(q, k, v), (q, k, v), dout)
    check(k2.launch_counts() == {"tensor_core": 1, "simt": 0},
          f"FlashAttention's forward launched K2 {k2.launch_counts()}")
    out32, lse = flash_attention_online(q.detach(), k.detach(), v.detach(),
                                        with_lse=True)
    want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                     out32, lse, dout)
    attn = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        rel = float((a.float() - b.float()).abs().max()
                    / b.float().abs().max())
        check(rel <= 2e-2, f"FlashAttention {name}: max abs err {rel} of "
                           f"the largest entry > 2e-2")
        attn[name] = rel
    del q, k, v, dout, got, want, out32, lse
    x, dt, A, Bm, Cm = ssd_inputs(g, 1, TRAIN_S, 80, 1, 64, 128,
                                  torch.bfloat16, ramp=True)
    ins = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    dy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
    k3.reset_launch_count()
    y = ops.ssd_scan(*ins, chunk=128)
    got = torch.autograd.grad(y, ins, dy)
    check(k3.launch_counts() == {"tensor_core": 1, "simt": 0},
          f"SSDScan's forward launched K3 {k3.launch_counts()}")
    with torch.no_grad():
        y32 = ssd_chunked(*(t.detach().float() for t in ins), 128)[0]
    y_abs, y_row = attention_errors(y.detach(), y32)
    check(y_row <= ROW_REL_TOL,
          f"SSDScan's forward through K3: worst row error {y_row} > "
          f"{ROW_REL_TOL} of the float32 plain version")
    plain = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    want = torch.autograd.grad(ssd_chunked(*plain, 128)[0], plain, dy)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    check(same, "SSDScan's gradients differ from the all-plain ones")
    del x, dt, A, Bm, Cm, ins, plain, y, y32, got, want
    torch.cuda.empty_cache()
    return {"attention_max_abs_err_of_largest": attn,
            "attention_tolerance": "2e-2 of each gradient's largest entry",
            "ssd_forward": {"max_abs_err": y_abs,
                            "worst_row_rel_err": y_row,
                            "tolerance": f"each row <= {ROW_REL_TOL} of "
                                         f"the float32 plain version"},
            "ssd_plain_recompute_gradients_equal": same}


def train_parity(card: str) -> dict:
    """(c): one ``make_train_step`` step at full width, depth cut
    (:data:`TRAIN_PARITY`), float32 (TF32 off), B 1, S 128, on the card
    (K2 and K3 on their SIMT variants, twice a layer: the forward and the
    remat recompute) and on the CPU from one set of parameters: the loss,
    and the gradients as the first step's ``mu`` ((1 - b1) times the
    clipped gradient), within rtol = atol = 1e-3 of each leaf's largest
    entry."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.train import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch, n_layers in TRAIN_PARITY:
        cfg, on_card, on_cpu = card_and_cpu_models(arch, n_layers)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (1, 129)))
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        step = make_train_step(cfg)
        k2.reset_launch_count()
        k3.reset_launch_count()
        t0 = time.perf_counter()
        card_state, got = step(init_train_state(cfg, model=on_card),
                               {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = {"k2": k2.launch_counts(), "k3": k3.launch_counts()}
        t0 = time.perf_counter()
        cpu_state, want = step(init_train_state(cfg, model=on_cpu), batch)
        cpu_s = time.perf_counter() - t0
        loss_err = abs(float(got["loss"]) - float(want["loss"]))
        worst, worst_leaf = 0.0, None
        for name, mu in cpu_state["opt"]["mu"].items():
            d = (card_state["opt"]["mu"][name].cpu() - mu).abs().max()
            rel = float(d / mu.abs().max().clamp_min(1e-30))
            if rel > worst:
                worst, worst_leaf = rel, name
        what = f"{arch} {n_layers}-layer train step"
        n_attn = -(-n_layers // max(cfg.shared_attn_every, 1)) \
            if cfg.family == "hybrid" else \
            (n_layers if cfg.family == "dense" else 0)
        n_ssd = n_layers if cfg.family in ("ssm", "hybrid") else 0
        # float32: both on their SIMT variants, forward and remat recompute
        check(launches == {"k2": {"tensor_core": 0, "simt": 2 * n_attn},
                           "k3": {"tensor_core": 0, "simt": 2 * n_ssd}},
              f"{what} launched {launches}")
        check(bool(torch.isfinite(got["loss"])), f"{what}: loss not finite")
        check(loss_err <= 1e-3 * max(1.0, abs(float(want["loss"]))),
              f"{what}: loss on the card {float(got['loss'])} against "
              f"{float(want['loss'])} on the CPU")
        check(worst <= 1e-3, f"{what}: gradient {worst_leaf} differs by "
                             f"{worst} of its largest entry")
        out[arch] = {"n_layers": n_layers, "loss": float(want["loss"]),
                     "loss_abs_err": loss_err,
                     "grad_max_err_of_largest": worst,
                     "worst_leaf": worst_leaf, "launches": launches,
                     "card_s": card_s, "cpu_s": cpu_s}
        del on_card, on_cpu, card_state, cpu_state
        torch.cuda.empty_cache()
    return {"configs": out,
            "tolerance": "1e-3 of the loss and of each gradient leaf's "
                         "largest entry"}


def plain_backward_ms(prof) -> dict[str, float]:
    """Device milliseconds of the kernels launched inside each plain
    backward (:data:`PLAIN_BACKWARDS`): a kernel record's host operation
    (by linked correlation id) that starts on the thread and inside the
    span of such an autograd node's host record."""
    import bisect
    events = list(prof.profiler.kineto_results.events())
    ops, spans = {}, {}
    for ev in events:
        if str(ev.device_type()) == "DeviceType.CUDA":
            continue
        ops[ev.correlation_id()] = ev
        for node in PLAIN_BACKWARDS:
            if ev.name() == f"autograd::engine::evaluate_function: {node}":
                spans.setdefault(ev.start_thread_id(), []).append(
                    (ev.start_ns(), ev.end_ns(), node))
    for held in spans.values():
        held.sort()
    starts = {t: [s for s, _, _ in held] for t, held in spans.items()}
    ms = dict.fromkeys(PLAIN_BACKWARDS, 0.0)
    for ev in events:
        if str(ev.device_type()) != "DeviceType.CUDA":
            continue
        op = ops.get(ev.linked_correlation_id())
        if op is None or op.start_thread_id() not in spans:
            continue
        held = spans[op.start_thread_id()]
        i = bisect.bisect_right(starts[op.start_thread_id()],
                                op.start_ns()) - 1
        if i >= 0 and op.start_ns() <= held[i][1]:
            ms[held[i][2]] += ev.duration_ns() / 1e6
    return ms


def profile_train_step(state, arch: str, B: int, kernel: str,
                       launches: int) -> dict:
    """One more train step on the run's final state, profiled as
    :func:`profiled` profiles (a lead-in, up to :data:`PROFILE_TRIES`
    sessions, none counted that lost a launch of ``kernel``; the step
    makes ``launches`` of them): device time, idle share, the top
    kernels, the kernel's share and the plain backwards'
    (:func:`plain_backward_ms`)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import make_train_step
    cfg = state["params"].cfg
    step = make_train_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (B, TRAIN_S + 1),
                           device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(32))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    lost = []
    for n in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = kernel_rows(prof)
        lost.append(LEAD_IN - sum(n for k, (_, n) in rows.items()
                                  if LEAD_IN_KERNEL in k))
        rows = {k: v for k, v in rows.items() if LEAD_IN_KERNEL not in k}
        seen = matching(rows, kernel)[1]
        if seen == launches:
            plain_ms = plain_backward_ms(prof)
            PROFILE_LOG.append({"profile": f"the {arch} train step",
                                "sessions": n, "lead_in_records_lost": lost})
            break
        print(f"chip_smoke: profile session {n} of the {arch} train step "
              f"recorded {seen} of its {launches} {kernel} launches (and "
              f"lost {lost[-1]} of its {LEAD_IN} lead-in records)",
              file=sys.stderr, flush=True)
        del prof
    else:
        fail(f"{PROFILE_TRIES} profile sessions of the {arch} train step "
             f"all lost launch records")
    del prof
    busy = sum(ms for ms, _ in rows.values())
    kernel_ms = matching(rows, kernel)[0]
    plain = sum(plain_ms.values())
    top = sorted(((k, ms, n) for k, (ms, n) in rows.items()),
                 key=lambda r: -r[1])[:10]
    return {"wall_ms": wall * 1e3, "device_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3),
            "device_ops": sum(n for _, n in rows.values()),
            "kernel": kernel, "kernel_ms": kernel_ms,
            "kernel_share": kernel_ms / busy,
            "plain_backward_ms": plain_ms,
            "plain_backward_share": plain / busy,
            "top": [{"name": k[:80], "device_ms": ms, "launches": n}
                    for k, ms, n in top]}


class TrainRun:
    """Observes one run of the training launcher in this process
    (``repro_torch.launch.train.main``): per step the loss, grad norm and
    lr, the seconds since the previous step ended (the first from the
    call, so it holds the set-up; a step after a save holds the save),
    K2's and K3's launches by variant; the peak memory."""

    def __init__(self, after_step=None):
        from repro_torch.kernels import flash_attention as k2
        from repro_torch.kernels import ssd_scan as k3
        self.k2, self.k3 = k2, k3
        self.steps: list[dict] = []
        self.after_step = after_step

    def __call__(self, argv: list[str], save_every: int, **hooks):
        from repro_torch.launch import train as launch_train
        self.save_every = save_every
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.k2.reset_launch_count()          # the main path's run only
        self.k3.reset_launch_count()
        self.t = time.perf_counter()
        first = len(self.steps)
        state = launch_train.main(argv, on_step=self.on_step, **hooks)
        self.peak = torch.cuda.max_memory_allocated()
        self.steps[first]["after"] = "set-up"
        return state

    def on_step(self, step: int, state: dict, metrics: dict) -> None:
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec.update(seconds=now - self.t, k2=self.k2.launch_counts(),
                   k3=self.k3.launch_counts(),
                   after="save" if self.steps and self.steps[-1]["step"]
                   % self.save_every == 0 and self.steps[-1]["step"]
                   == step - 1 else "step")
        self.steps.append(rec)
        if self.after_step is not None:
            self.after_step(step, state)
        self.k2.reset_launch_count()
        self.k3.reset_launch_count()
        self.t = time.perf_counter()

    def clean_seconds(self) -> list[float]:
        """The seconds of the steps that followed a step with no save."""
        return [r["seconds"] for r in self.steps if r["after"] == "step"]


def train_args(arch: str, B: int, steps: int, save_every: int,
               ckpt: Path) -> list[str]:
    return ["--arch", arch, "--full", "--batch", str(B), "--seq",
            str(TRAIN_S), "--steps", str(steps), "--save-every",
            str(save_every), "--checkpoint-dir", str(ckpt)]


def check_train_steps(what: str, run: TrainRun, k2_want: dict,
                      k3_want: dict) -> None:
    for r in run.steps:
        check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
              f"{what} step {r['step']}: loss {r['loss']}, grad norm "
              f"{r['grad_norm']}")
        check(r["k2"] == k2_want and r["k3"] == k3_want,
              f"{what} step {r['step']} launched K2 {r['k2']} and K3 "
              f"{r['k3']}, expected {k2_want} and {k3_want}")


def train_qwen3(card: str, ckpt: Path) -> dict:
    """(d): qwen3-0.6b, 28 layers, B 4, S 4,096 through the launcher:
    :data:`TRAIN_QWEN3_STEPS` steps saving every
    :data:`TRAIN_SAVE_EVERY`; then the checkpoint past the first save is
    set aside and a second invocation resumes from the first save to the
    same end (saving nothing). Checks: the first loss within 0.5 of ln V;
    every loss and grad norm finite; 56 K2 launches a step (28 layers'
    forward and remat recompute), all tensor core; the restored tensors
    equal bitwise those the first run held at the save; the resumed steps'
    losses within :data:`TRAIN_RESUME_TOL` of the first run's."""
    import math
    import shutil
    from repro_torch.configs import SHAPES, get_config
    cfg = get_config("qwen3-0.6b")
    arch_dir = ckpt / cfg.name
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = train_args(cfg.name, TRAIN_QWEN3_B, TRAIN_QWEN3_STEPS,
                      TRAIN_SAVE_EVERY, ckpt)
    held = {}

    def hold(step, state):
        if step == TRAIN_SAVE_EVERY:        # what the first save writes
            held["state"] = flat_state(state)

    run = TrainRun(after_step=hold)
    state = run(argv, TRAIN_SAVE_EVERY)
    n_params = sum(p.numel() for p in state["params"].parameters())
    del state
    torch.cuda.empty_cache()
    first = list(run.steps)
    peak = run.peak
    # the restart: the checkpoint past the first save set aside
    aside = ckpt / "aside"
    for p in arch_dir.glob("step_*"):
        if int(p.name.split("_")[1].split(".")[0]) > TRAIN_SAVE_EVERY:
            aside.mkdir(parents=True, exist_ok=True)
            p.rename(aside / p.name)
    same = {}

    def on_restore(state, manifest):
        got = flat_state(state)
        same["keys"] = sorted(got) == sorted(held["state"])
        same["bitwise"] = same["keys"] and all(
            torch.equal(got[k], held["state"][k]) for k in got)
        same["step"] = manifest["step"]
        del got
        held.clear()
    # the restart saves nothing (each save writes 8.5 GB, about 8 s)
    resumed = TrainRun()
    state = resumed(train_args(cfg.name, TRAIN_QWEN3_B, TRAIN_QWEN3_STEPS,
                               TRAIN_QWEN3_STEPS + 1, ckpt),
                    TRAIN_QWEN3_STEPS + 1, on_restore=on_restore)
    peak = max(peak, resumed.peak)
    k2_want = {"tensor_core": 2 * cfg.n_layers, "simt": 0}
    what = f"{cfg.name} training"
    check(abs(first[0]["loss"] - math.log(cfg.vocab_size)) <= 0.5,
          f"{what}: first loss {first[0]['loss']}, ln V "
          f"{math.log(cfg.vocab_size)}")
    check_train_steps(what, run, k2_want, {"tensor_core": 0, "simt": 0})
    check_train_steps(f"{what} (resumed)", resumed, k2_want,
                      {"tensor_core": 0, "simt": 0})
    check(same.get("bitwise") is True and same["step"] == TRAIN_SAVE_EVERY,
          f"{what}: the restored state is not the one saved at step "
          f"{TRAIN_SAVE_EVERY}: {same}")
    check([r["step"] for r in resumed.steps]
          == list(range(TRAIN_SAVE_EVERY + 1, TRAIN_QWEN3_STEPS + 1)),
          f"{what}: the restart ran steps "
          f"{[r['step'] for r in resumed.steps]}")
    gaps = [abs(a["loss"] - b["loss"]) for a, b in
            zip(resumed.steps, first[TRAIN_SAVE_EVERY:])]
    check(max(gaps) <= TRAIN_RESUME_TOL,
          f"{what}: resumed losses differ by {gaps}")
    clean = run.clean_seconds() + resumed.clean_seconds()
    median = float(np.median(clean))
    profile = profile_train_step(state, cfg.name, TRAIN_QWEN3_B,
                                 K2_KERNEL, 2 * cfg.n_layers)
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)
    spec = SHAPES["train_4k"]
    return {"config": f"{cfg.name}, {cfg.n_layers} layers, full width, "
                      f"bf16 compute over float32 masters, remat "
                      f"{cfg.remat}",
            "params": n_params, "B": TRAIN_QWEN3_B, "S": TRAIN_S,
            "reduced": {"global_batch": f"{spec.global_batch} -> "
                                        f"{TRAIN_QWEN3_B}",
                        "why": "one card and the run's time limit"},
            "ln_V": math.log(cfg.vocab_size), "steps": first,
            "resumed_steps": resumed.steps, "resumed_loss_gaps": gaps,
            "resume_tolerance": TRAIN_RESUME_TOL,
            "restored_bitwise": same["bitwise"],
            "median_step_s": median, "clean_step_s": clean,
            "tokens_per_s": TRAIN_QWEN3_B * TRAIN_S / median,
            "peak_mem_bytes": peak,
            "k2_launches_per_step": [r["k2"] for r in first + resumed.steps],
            "k2_launches_expected": k2_want, "profile": profile}


def flat_state(state: dict) -> dict[str, torch.Tensor]:
    """Host copies of every tensor of a train state, by path (on the host,
    so that the peak device memory stays the run's own)."""
    out = {f"params/{n}": p.detach().cpu()
           for n, p in state["params"].named_parameters()}
    for m in ("mu", "nu"):
        out.update({f"{m}/{n}": t.cpu() for n, t in state["opt"][m].items()})
    out["count"] = state["opt"]["count"].cpu()
    out["step"] = state["step"].cpu()
    return out


def train_mamba2(card: str, ckpt: Path) -> dict:
    """(e): mamba2-2.7b, 64 layers, B 1, S 4,096, microbatches 1, through
    the launcher (no save within the run): every loss and grad norm
    finite, 128 K3 launches a step (the forward and the remat
    recompute), all tensor core, no K2."""
    import math
    import shutil
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-2.7b")
    shutil.rmtree(ckpt, ignore_errors=True)
    run = TrainRun()
    state = run(train_args(cfg.name, TRAIN_MAMBA2_B, TRAIN_MAMBA2_STEPS,
                           TRAIN_MAMBA2_STEPS + 1, ckpt)
                + ["--microbatches", "1"], TRAIN_MAMBA2_STEPS + 1)
    n_params = sum(p.numel() for p in state["params"].parameters())
    k3_want = {"tensor_core": 2 * cfg.n_layers, "simt": 0}
    check_train_steps(f"{cfg.name} training", run,
                      {"tensor_core": 0, "simt": 0}, k3_want)
    clean = run.clean_seconds()
    median = float(np.median(clean))
    profile = profile_train_step(state, cfg.name, TRAIN_MAMBA2_B,
                                 K3_KERNELS["tensor_core"],
                                 2 * cfg.n_layers)
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"config": f"{cfg.name}, {cfg.n_layers} layers, full width, "
                      f"bf16 compute over float32 masters, remat "
                      f"{cfg.remat}",
            "params": n_params, "B": TRAIN_MAMBA2_B, "S": TRAIN_S,
            "ln_V": math.log(cfg.vocab_size), "steps": run.steps,
            "median_step_s": median, "clean_step_s": clean,
            "tokens_per_s": TRAIN_MAMBA2_B * TRAIN_S / median,
            "peak_mem_bytes": run.peak,
            "k3_launches_per_step": [r["k3"] for r in run.steps],
            "k3_launches_expected": k3_want, "profile": profile}


def phase_train(card: str) -> dict:
    """Phase ``train``: (a) to (e) of the module docstring."""
    t0 = time.perf_counter()
    out = {"card": card, "lse": train_lse(card)}
    out["grads"] = train_grads(card)
    out["parity"] = train_parity(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    ckpt = ROOT / "build" / "train_ckpt"
    out["qwen3"] = train_qwen3(card, ckpt)
    out["mamba2"] = train_mamba2(card, ckpt)
    out["phase_s"] = time.perf_counter() - t0
    emit("train", **out)
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
    ap.add_argument("--build-cluster-b2", metavar="PATH",
                    help="build cluster_b(scale=2) and pickle its plain "
                         "dict to PATH (the whole run's own use)")
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
    if args.build_cluster_b2:
        return build_cluster_b2_alone(args.build_cluster_b2)
    if args.plan_only:
        phase_full(phase_env()["card"])
        return 0
    b2 = start_cluster_b2()
    try:
        return run_all(b2)
    finally:
        if b2.poll() is None:               # a phase before it failed
            b2.kill()
            b2.wait()


def run_all(b2: subprocess.Popen) -> int:
    """Every phase in order, cluster B x2 from :func:`start_cluster_b2`'s
    process; the kernel table line and the last line."""
    env = phase_env()
    card = env["card"]
    built_b = build_cluster_b()
    k1 = phase_k1(card, built_b[0], env)
    phase_small()
    full = phase_full(card, built=built_b)
    phase_full(card, scale=2, built=built_cluster_b2(b2))
    phase_no_sync()
    warm = phase_warm(card, built_b[0])
    dense = phase_dense_lanes(card, built_b[0], full)
    phase_replay(card, built_b[0], full)
    life = phase_lifecycle(card, built_b[0])
    scen = phase_scenarios(card)
    fz = phase_fuzz(card, built_b[0], life)
    k2 = phase_k2(card)
    k3 = phase_k3(card)
    phase_lm_parity(card)
    pre = phase_prefill(card)
    phase_lm_parity(card, "mamba2-2.7b", 4, (0, 4), "mamba2_parity")
    pre_m = phase_prefill(card, "mamba2-2.7b", 0,
                          {"tensor_core": 64, "simt": 0}, "mamba2_prefill")
    # last, so that every earlier phase runs as it did before the opt-ins
    optins = phase_batch_optins(card, built_b[0], k1)
    blocks = phase_source_block(card, built_b[0])
    fleet = phase_fleet(card, built_b[0], full, env)
    shard = phase_shard(card, built_b[0], full, env)
    phase_serve(card)
    train = phase_train(card)
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
                              pre_m["k3_launches_by_variant"],
                          "mamba2-2.7b train steps, counted a step":
                              train["mamba2"]["k3_launches_per_step"]},
        tc_at_mamba2_shape={
            "launches": pre_m["k3_launches_by_variant"]["tensor_core"],
            "max_abs_err": tc_m["errors"]["tc_max_abs_err"],
            "library_ms": None} | {k: tc_m[k] for k in timing},
        simt_at_mamba2_shape={
            "launches": pre_m["k3_launches_by_variant"]["simt"],
            "dtype": "float32",
            "max_abs_err": simt["errors"]["max_abs_err"],
            "library_ms": None} | {k: simt[k] for k in timing})
    # K1's entry is the fused kernel the batch planner launches; the
    # standalone reduction, which the legacy lane launches once per
    # evaluated source, stands beside it
    k1_entry = kernel_entry("select_rows", "masked_select.cu",
                            "src/repro/kernels/select_move.py:44",
                            full["k1_launches"], k1)
    alone = k1["standalone"]
    legacy_b = dense["cluster_b"]["equilibrium_jax_legacy"][
        "evaluated_sources"]
    k1_entry.update(
        launches_by_kernel={"select_rows": full["k1_launches"],
                            "masked_select": legacy_b},
        launches_by_path={"cluster B cold plan": full["k1_launches"],
                          "cluster B warm lifecycle": warm["k1_launches"],
                          "cluster B legacy lane": legacy_b,
                          "cluster B simulator lifecycle":
                              life["select_rows_launches"],
                          "six scenarios": scen["select_rows_launches"],
                          "fuzz sweep": {
                              k: sum(fz["k1_launches"][p][k]
                                     for p, _ in FUZZ_SWEEP)
                              for k in ("select_rows", "masked_select")},
                          "fuzz corpus": {
                              k: fz["k1_launches"]["corpus"][k]
                              for k in ("select_rows", "masked_select")},
                          "fuzz sweep and corpus, fleet lane":
                              fz["fleet_lane"]["select_rows_launches"],
                          "cluster B lifecycle under the fuzzer's oracles":
                              fz["cluster_b"]["k1_launches"],
                          "cluster B at source_block 3 and 25":
                              blocks["k1_launches"]["select_rows"],
                          "cluster-B fleet (8 lanes)":
                              fleet["cluster_b_fleet"]["k1_launches"],
                          "paper fleet (A-F)":
                              fleet["paper_fleet"]["k1_launches"],
                          "cluster B sharded (world 1), window form":
                              shard["k1_launches"]["select_rows_window"],
                          "fuzz sweep and corpus, sharded lane, window "
                          "form":
                              fz["sharded_lane"][
                                  "select_rows_window_launches"]},
        fleet_8_lanes={
            "launches": fleet["cluster_b_fleet"]["k1_launches"],
            **{k: fleet["k1"][k] for k in (
                "at", "lanes", "shape", "max_abs_err", "ms", "device_ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_device_ms")},
            "lanes_1_at_lane_0": fleet["k1"]["lanes_1_at_lane_0"]},
        window_form={
            "launches": shard["k1_launches"]["select_rows_window"],
            **{k: shard["k1"][k] for k in (
                "at", "shape", "max_abs_err", "ms", "device_ms",
                "device_memory", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms", "windows_checked",
                "folds_checked")}},
        standalone_masked_select={
            "launches": legacy_b,
            "max_abs_err": dense["cluster_b"]["equilibrium_jax_legacy"][
                "max_abs_err"],
            **dense["cluster_b"]["equilibrium_jax_legacy"][
                "k1_at_lane_shape"],
            "at_batch_step_shape": {k: alone[k] for k in (
                "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms",
                "library_device_ms")}})
    # the cached instantiation: its launches on cluster B's plan with the
    # cache (phase batch_optins), its times at cluster B's first step
    k1_cached_entry = kernel_entry("select_rows_cached", "masked_select.cu",
                                   "src/repro/kernels/select_move.py:44",
                                   optins["k1_cached_launches"],
                                   optins["k1_cached"])
    k1_cached_entry.update(
        variant="cached instantiation (legality_cache=True)",
        launches_by_path={
            "cluster B plan with the cache": optins["k1_cached_launches"],
            "fuzz sweep with the cache":
                optins["fuzz"]["k1_launches"],
            "cluster B at source_block 3 and 25 with the cache":
                blocks["k1_launches"]["select_rows_cached"]},
        hit={"ms": optins["k1_cached"]["hit_ms"],
             "device_ms": optins["k1_cached"]["hit_device_ms"]},
        uncached_at_same_step={
            "ms": optins["k1_cached"]["uncached_ms"],
            "device_ms": optins["k1_cached"]["uncached_device_ms"]})
    # K2's launches and times are the zamba2 prefill's; the launches the
    # qwen3 training run counted on each step (with the lse) stand beside
    k2_entry = kernel_entry("flash_attention", "flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:87",
                            pre["k2_launches"], k2)
    k2_entry.update(launches_by_path={
        "zamba2-7b prefill": pre["k2_launches"],
        "qwen3-0.6b train steps, with the lse, counted a step":
            train["qwen3"]["k2_launches_per_step"]},
        lse_max_abs_err={k: v["max_abs_err"]
                         for k, v in train["lse"]["cases"].items()})
    emit("profiles", sessions=PROFILE_LOG)
    print(json.dumps({"kernels": [
        k1_entry,
        k1_cached_entry,
        k2_entry,
        k3_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
