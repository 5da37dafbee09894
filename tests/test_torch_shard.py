"""The port's sharded batch engine (``repro_torch.core.shard``) against
the port's serial batch engine and the JAX package's
``ShardedBatchPlanner``, on the CPU; every comparison is exact.

* At world sizes 1 (no process group, in this process), 2 and 4 (gloo
  groups of spawned processes, ``spawn_ranks``), each case of
  ``tests/_ref_shard.py`` (cluster A, whose 14 devices pad unevenly at 4
  ranks, and a 16-device cluster that divides evenly; a 16-device cluster
  of equal shards whose winners tie across ranks; source bounds on and
  off; source_block 1 and 3; ``pad_devices``; a warm continuation
  through growth, a device out and a device add) equals the port's serial
  ``equilibrium_batch`` (moves, variance after each move, sources tried,
  certificate counters, tiles walked and candidate tiles, rebuilds and
  absorptions) and the reference's sharded engine at the same mesh size
  (all of that and the per-shard ``batch.shard.*`` counters), which
  ``tests/_ref_shard.py`` plays in a subprocess of its own per mesh size.
  One spawn and one reference subprocess per size, all started together
  when the first test asks for them and shared by the parametrised cases.
* The plain version of K1's window form, ``select_rows_window_ref``, at
  2- and 4-way windows of the ``tests/_select_rows_carries.py`` carries
  equals the reference's legality mask restricted to the window and
  reduced by its ``masked_select_ref``; folding the windows with
  ``shard_winner_better`` gives the unwindowed ``select_rows_ref``.
* The five cross-shard helpers of the port's legality core equal the
  reference's on NumPy inputs, and on torch tensors.
* The refusals, a world-1 gloo group in this process, the memory stats
  and a hypothesis property at world 1 (20 examples).
"""

import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from _hypothesis_compat import given, settings, strategies as st

import _ref_shard
from _select_rows_carries import (CARRIES, carry, carry_id, fold_windows,
                                  window_args)
from test_torch_select_rows import reduce_reference, reference_masks
from repro.core import legality as ref_leg
from repro_torch import obs
from repro_torch.core import (Device, EquilibriumConfig, PlacementRule, Pool,
                              TiB, build_cluster, cluster, clustergen,
                              legality)
from repro_torch.core.planner import available_planners, create_planner
from repro_torch.core.shard import (ShardedBatchPlanner, chunk_memory_stats,
                                    spawn_ranks)
from repro_torch.kernels.ref import select_rows_ref, select_rows_window_ref

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
WORLDS = (1, 2, 4)
CASES = tuple(_ref_shard.CASES)
#: every record key held equal to the serial engine's (the per-shard
#: counters have no serial counterpart)
SERIAL_COUNTERS = _ref_shard.COUNTERS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side: keep torch's
    CPU ops on one thread each so they do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Runs:
    """Every cross-process run, started together: the reference at meshes
    1, 2 and 4 (a subprocess each), the port at worlds 2 and 4 (a spawned
    gloo group each, from a thread)."""

    def __init__(self):
        # one XLA thread a subprocess: five run beside the test process
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_cpu_multi_thread_eigen=false",
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
        self.ref = {m: subprocess.Popen(
            [sys.executable, str(HERE / "_ref_shard.py"), "--mesh", str(m)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO) for m in WORLDS}
        self.pool = ThreadPoolExecutor(2)
        # a rank that waits two minutes on a collective fails its group
        self.ports = {w: self.pool.submit(spawn_ranks, _ref_shard.port_ranks,
                                          w, "gloo", (CASES,), 120.0)
                      for w in WORLDS if w > 1}
        self._ref_out = {}

    def reference(self, mesh: int) -> dict:
        if mesh not in self._ref_out:
            out, err = self.ref[mesh].communicate(timeout=300)
            assert self.ref[mesh].returncode == 0, err[-4000:]
            self._ref_out[mesh] = json.loads(out.strip().splitlines()[-1])
        return self._ref_out[mesh]

    def port(self, world: int) -> list[dict]:
        """Each rank's records."""
        return self.ports[world].result(timeout=300)

    def close(self):
        for proc in self.ref.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
        self.pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def runs():
    r = Runs()
    yield r
    r.close()


def port_drive(case: str, planner: str = "equilibrium_batch_sharded"):
    return _ref_shard.drive(case, clustergen, cluster, obs, create_planner,
                            planner=planner, device="cpu")


@pytest.fixture(scope="module")
def serial():
    return {case: port_drive(case, "equilibrium_batch") for case in CASES}


@pytest.fixture(scope="module")
def world1():
    return {case: port_drive(case) for case in CASES}


def _without_shard_counters(plans: list[dict]) -> list[dict]:
    return [{**p, "counters": {k: v for k, v in p["counters"].items()
                               if k in SERIAL_COUNTERS}} for p in plans]


def _port_records(world: int, runs, world1) -> list[list[dict]]:
    """Each rank's records of the port at ``world`` ranks."""
    if world == 1:
        return [world1]
    return runs.port(world)


def test_sharded_lane_registered(runs):
    """The lane is in the registry and the ``"equilibrium"`` class; asking
    for ``runs`` here starts every cross-process run while the in-process
    tests below go on."""
    assert "equilibrium_batch_sharded" in available_planners()
    p = create_planner("equilibrium_batch_sharded", device="cpu")
    res = p.plan(clustergen.small_test_cluster(), budget=4)
    assert res.stats["shards"] == 1 and res.stats["engine"] == "batch-sharded"
    assert len(res.moves) == 4


# ---------------------------------------------------------------------------
# K1's window form: the plain version


@pytest.mark.parametrize("ways", [2, 4])
@pytest.mark.parametrize("case", CARRIES, ids=carry_id)
def test_window_ref_matches_reference_mask(case, ways):
    """Each window's (any, dst, cand_src, cand_row) equals the JAX
    package's legality mask over the window's devices (pads: none legal),
    reduced by its ``masked_select_ref``, with global indices."""
    args = carry(*case)
    cand, var_ok, util, avail = reference_masks(*args)
    n = util.shape[0]
    for rank in range(ways):
        wargs, base = window_args(args, ways, rank)
        n_local = wargs[7]["dst_ok"].shape[1]
        cols = np.arange(base, base + n_local)
        real = cols < n

        def window(m, fill):
            out = np.full(m.shape[:-1] + (n_local,), fill, dtype=m.dtype)
            out[..., real] = m[..., cols[real]]
            return out

        want = reduce_reference(window(cand, False), window(var_ok, False),
                                window(util, 0.0), avail)
        got = select_rows_window_ref(*wargs, base=base, cand_row=True)
        assert np.array_equal(got[0].numpy(), want[0])
        assert got[1].dtype == torch.int32
        assert np.array_equal(got[1].numpy(), want[1] + base)
        assert np.array_equal(got[2].numpy(), want[2])
        assert np.array_equal(got[3].numpy(),
                              window(cand, False).any(axis=2))


@pytest.mark.parametrize("case", CARRIES, ids=carry_id)
def test_window_fold_equals_unwindowed(case):
    """The 1-, 2- and 4-way windows, each with every position available,
    folded in ascending order with ``shard_winner_better`` and masked by
    the available positions, give ``select_rows_ref``'s any, dst and
    cand_src on the whole carry, bit for bit, as the engine folds them."""
    args = carry(*case)
    want = select_rows_ref(*args)
    k = args[0].shape[0]
    avail = torch.arange(k) < args[1]
    for ways in (1, 2, 4):
        outs = []
        for rank in range(ways):
            wargs, base = window_args(args, ways, rank)
            wargs = (wargs[0], torch.tensor(k), *wargs[2:])
            outs.append((*select_rows_window_ref(*wargs, base=base),
                         wargs[7]["util"]))
        got = fold_windows(outs, avail)
        for g, w in zip(got, want):
            assert torch.equal(g, w), ways


# ---------------------------------------------------------------------------
# the legality core's cross-shard helpers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shard_helpers_match_reference(seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-2, 40, 64)
    vals = rng.integers(-5, 100, 64)
    owns = rng.random(64) < 0.5
    any_n, any_b = rng.random(64) < 0.5, rng.random(64) < 0.5
    u_n = rng.choice([0.1, 0.2, 0.3], 64)       # ties on purpose
    u_b = rng.choice([0.1, 0.2, 0.3], 64)
    d_n, d_b = rng.integers(0, 40, 64), rng.integers(0, 40, 64)
    calls = {
        "shard_owns": (idx, 8, 16),
        "shard_gather_contrib": (vals, owns.astype(np.int64), -1),
        "shard_gather_finish": (vals, -1),
        "shard_any": (rng.integers(0, 3, 64),),
        "shard_winner_better": (any_n, u_n, d_n, any_b, u_b, d_b),
    }
    for name, call in calls.items():
        want = getattr(ref_leg, name)(*call)
        got = getattr(legality, name)(*call)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
        lifted = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                  for a in call]
        got_t = getattr(legality, name)(*lifted)
        assert np.array_equal(got_t.numpy(), want), name
        assert getattr(legality, name).__name__ == name


# ---------------------------------------------------------------------------
# the engine: refusals, a group of one, memory, a property


def test_refusals():
    state = clustergen.small_test_cluster()
    with pytest.raises(ValueError, match="legality cache"):
        ShardedBatchPlanner(state, legality_cache=True, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        ShardedBatchPlanner(state, n_shards=2, device="cpu")
    # an override below the natural width is refused when the carry pads
    bp = ShardedBatchPlanner(state, n_shards=1, pad_devices=4, device="cpu")
    with pytest.raises(ValueError, match="required width"):
        bp.plan(max_moves=2)
    # the registry's adapter takes no legality cache at all
    p = create_planner("equilibrium_batch_sharded", legality_cache=True,
                       device="cpu")
    assert "legality_cache" not in p._engine_kwargs


def test_world_one_gloo_group_in_process(serial):
    """In a gloo group of one rank (every collective through
    torch.distributed) cluster A plans as the serial engine does; an
    ``n_shards`` that is not the group's size is refused."""
    assert not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            with pytest.raises(ValueError, match="has 1 ranks"):
                ShardedBatchPlanner(clustergen.cluster_a(), n_shards=2,
                                    device="cpu")
            got = _ref_shard.drive("a", clustergen, cluster, obs,
                                   create_planner, device="cpu")
        finally:
            dist.destroy_process_group()
    assert _without_shard_counters(got) == serial["a"]
    assert got[0]["counters"]["batch.shard.wins{shard=0}"] \
        == len(got[0]["moves"])


def test_chunk_memory_stats():
    bp = ShardedBatchPlanner(clustergen.cluster_a(), device="cpu")
    mem = chunk_memory_stats(bp)
    assert mem["argument_bytes"] > 0 and "peak_bytes" not in mem
    # the carry is untouched: the plan is the serial one
    moves, _ = bp.plan()
    want, _ = create_planner("equilibrium_batch", device="cpu").plan(
        clustergen.cluster_a()).as_tuple()
    assert [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in moves] \
        == [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in want]


@st.composite
def shard_cluster(draw):
    """A small random cluster (4 to 7 hosts of 1 or 2 devices, one 3x
    pool) and a pad of 0 to 3 devices, as the reference's property draws
    it."""
    seed = draw(st.integers(0, 2 ** 16))
    rng = np.random.default_rng(seed)
    devs = []
    for h in range(draw(st.integers(4, 7))):
        for _ in range(draw(st.integers(1, 2))):
            devs.append(Device(id=len(devs),
                               capacity=float(rng.choice([4, 8, 12])) * TiB,
                               device_class="hdd", host=f"host{h}"))
    total = sum(d.capacity for d in devs)
    pools = [Pool(0, "a", draw(st.integers(8, 24)),
                  PlacementRule.replicated(3, "host"),
                  stored_bytes=draw(st.floats(0.1, 0.4)) * total / 3)]
    return build_cluster(devs, pools, seed=seed), draw(st.integers(0, 3))


@settings(max_examples=20, deadline=None)
@given(case=shard_cluster())
def test_property_sharded_equals_serial(case):
    initial, pad = case
    cfg = EquilibriumConfig(max_moves=40)
    plain = initial.to_plain()
    a = create_planner("equilibrium_batch", cfg=cfg, chunk=16,
                       device="cpu").plan(
        cluster.ClusterState.from_plain(plain), record_trajectory=True)
    b = create_planner("equilibrium_batch_sharded", cfg=cfg, chunk=16,
                       pad_devices=initial.n_devices + pad if pad else None,
                       device="cpu").plan(
        cluster.ClusterState.from_plain(plain), record_trajectory=True)
    assert [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in a.moves] \
        == [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in b.moves]
    assert a.variance_trajectory == b.variance_trajectory
    assert a.stats["pruned_sources"] == b.stats["pruned_sources"]


# ---------------------------------------------------------------------------
# worlds 1, 2 and 4 against the serial engine and the reference


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_equals_serial(case, world, runs, serial, world1):
    """Every rank's plans equal the port's serial engine's."""
    for rank, records in enumerate(_port_records(world, runs, world1)):
        assert _without_shard_counters(records[case]) == serial[case], rank


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_equals_reference(case, world, runs, world1):
    """Rank 0's plans, per-shard counters included, equal the reference's
    sharded engine's at a mesh of the same size."""
    got = _port_records(world, runs, world1)[0][case]
    want = runs.reference(world)[case]
    assert got == want
    shards = {k.split("shard=")[1].rstrip("}") for p in got
              for k in p["counters"] if "shard=" in k}
    assert shards == {str(s) for s in range(world)}
