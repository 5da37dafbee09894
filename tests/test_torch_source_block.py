"""``source_block`` above 1 in the port's batch engine, held to the JAX
package's own batch engine, and ``repro_torch.core``'s public names.

At ``source_block`` kb the reference walks (source block, row block)
tiles of kb sources each, the last block padded with device 0; the port
evaluates the whole candidate tensor in one K1 launch a step and derives
the walk's outcome in closed form (``_Chunk.frontier``, ``certified``,
``walked``).  Every plan call here must give the reference engine's
moves, ``sources_tried`` histogram, ``bound_hits``, ``pruned_sources``
and registry deltas (``tests/_ref_batch_counters.py::COUNTERS``), with
the legality cache and the source bounds on and off; the reference runs
on JAX's CPU backend with three module attributes bound through
``monkeypatch`` (the ``reference`` fixture).  The closed form is also
held to a plain transcription of the reference's tile loop on random
walks, which reach the cases the paper clusters do not (no available
source at kb > 1).  Then the deprecated shims and ``__all__`` of
``repro_torch.core`` against the reference's."""

import ast
import json
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core._compat as ref_compat
import repro.core.equilibrium_batch as ref_batch
import repro_torch.core as port_core
from _hypothesis_compat import given, settings, strategies as st
from _lockstep import WARM, lockstep, totals
from _ref_batch_counters import (CLUSTER_B_CONFIG, COUNTERS, FIXTURE,
                                 counted_plan, record, reference_attrs)
from repro import obs as ref_obs
from repro.core import Device as RefDevice
from repro.core import clustergen as ref_gen
from repro.core.planner import create_planner as ref_create
from repro_torch import obs
from repro_torch.core import Device, TiB
from repro_torch.core import _compat as port_compat
from repro_torch.core import clustergen as port_gen
from repro_torch.core.equilibrium_batch import BatchPlanner, _Chunk
from repro_torch.core.planner import create_planner

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side: keep torch's
    CPU ops on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference(monkeypatch):
    """The JAX package's batch engine, runnable for one test."""
    for mod, name, value in reference_attrs():
        monkeypatch.setattr(mod, name, value, raising=False)
    return ref_batch


def as_tuples(moves):
    return [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in moves]


# ---------------------------------------------------------------------------
# lockstep: the port against the reference engine at each source block

#: (cluster, source_block, legality_cache, source_bounds, other options):
#: kb 3 (ragged: 16 and 14 sources in blocks of 3) and 2 with the cache
#: and the bounds on and off, 0 (clamped to 1), 25 and 100 (clamped to k:
#: one block, the latter sharing the former's compile of the reference
#: step); cluster A at kb 3 with the cache at row capacity 1 re-pads the
#: row table, as the opt-ins' table does at kb 1
REPAD = dict(row_capacity=1)
MATRIX = [("small_test_cluster", 3, True, True, {}),
          ("small_test_cluster", 3, False, False, {}),
          ("small_test_cluster", 0, True, True, {}),
          ("small_test_cluster", 2, False, True, {}),
          ("small_test_cluster", 25, True, False, {}),
          ("small_test_cluster", 100, True, False, {}),
          ("cluster_a", 3, True, False, REPAD),
          ("cluster_a", 25, True, True, {}),
          ("cluster_a", 25, False, False, {}),
          ("cluster_a", 2, True, False, {}),
          ("cluster_a", 100, True, True, {})]


@pytest.mark.parametrize("cluster,kb,cache,bounds,kw", MATRIX,
                         ids=[f"{c}-kb{kb}-{'cache' if ca else 'nocache'}-"
                              f"{'bounds' if b else 'nobounds'}"
                              f"{'-repad' if kw else ''}"
                              for c, kb, ca, b, kw in MATRIX])
def test_source_block_matches_reference(reference, cluster, kb, cache,
                                        bounds, kw):
    """A plan to convergence (at chunk 8 unless ``kw`` says otherwise),
    equal to the reference engine's in moves, histogram, certificate
    counters and every counter; the cache's hits and misses partition the
    tiles walked; the re-pad case re-pads, its fresh cache over the
    padded source positions."""
    kw = {"chunk": 8, **kw}
    rec, = lockstep(cluster, [None], source_block=kb, legality_cache=cache,
                    source_bounds=bounds, **kw)
    t = totals([rec])
    assert t["moves"] > 0 and t["tiles_walked"] >= t["cand_tiles"] > 0
    assert (t["cache_hits"] + t["cache_misses"] == t["tiles_walked"]) is cache
    assert (t["repads"] >= 1) is ("row_capacity" in kw)


@pytest.mark.parametrize("kb,rb", [(1, 1), (3, 5), (25, 64)])
def test_tile_shapes_match_faithful(kb, rb):
    """The reference's ``test_batch_tile_shapes_identical`` shapes on the
    port: the reference's ``equilibrium_faithful`` moves at each."""
    want = ref_create("equilibrium_faithful").plan(
        ref_gen.small_test_cluster())
    planner = BatchPlanner(port_gen.small_test_cluster(), source_block=kb,
                           row_block=rb, device="cpu")
    moves, _ = planner.plan()
    assert as_tuples(moves) == as_tuples(want.moves)
    assert planner._step.kb == min(kb, planner._step.k)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 40), kb=st.integers(1, 3), rb=st.integers(2, 8),
       bounds=st.booleans(), cache=st.booleans())
def test_bounds_cache_matrix_property(seed, kb, rb, bounds, cache):
    """After the reference's ``test_batch_bounds_cache_matrix_property``:
    the port's batch engine with the bounds and the cache on or off emits
    the reference's faithful sequence on seeded small clusters."""
    want = ref_create("equilibrium_faithful").plan(
        ref_gen.small_test_cluster(seed=seed))
    res = create_planner(
        "equilibrium_batch", source_block=kb, row_block=rb,
        source_bounds=bounds, legality_cache=cache, device="cpu").plan(
        port_gen.small_test_cluster(seed=seed))
    assert as_tuples(res.moves) == as_tuples(want.moves)
    assert res.stats["source_bounds"] is bounds
    assert res.stats["legality_cache"] is cache


# ---------------------------------------------------------------------------
# the closed form against the reference's tile loop


def reference_walk(k, kb, rb, R, n_avail, nrows, legal, cand):
    """The reference's ``lax.while_loop`` tile walk (``select_one``'s
    ``body``), transcribed: returns the winner (position, row) or None,
    the set of tiles walked and the set of positions certified."""
    k_pad = -(-k // kb) * kb
    n_rows = [nrows[q] if q < n_avail else 0 for q in range(k_pad)]
    sb = c = 0
    found = [-1] * kb
    marg = [False] * kb
    tiles, pruned = set(), set()
    while True:
        tiles.add((sb, c))
        rows = range(c * rb, (c + 1) * rb)
        for i in range(kb):
            q = sb * kb + i
            marg[i] |= any(cand[q][r] for r in rows)
            hits = [r for r in rows if legal[q][r]]
            if hits and q < n_avail and found[i] < 0:
                found[i] = hits[0]
        unres = [found[i] < 0 and n_rows[sb * kb + i] > (c + 1) * rb
                 for i in range(kb)]
        min_found = min([i for i in range(kb) if found[i] >= 0],
                        default=kb)
        min_unres = min([i for i in range(kb) if unres[i]], default=kb)
        decided = min_found < min_unres
        exhausted = min_found == kb and min_unres == kb
        if decided or exhausted:
            for i in range(kb):
                q = sb * kb + i
                if found[i] < 0 and not unres[i] and not marg[i] \
                        and q < n_avail:
                    pruned.add(q)
        if decided:
            return (sb * kb + min_found, found[min_found]), tiles, pruned
        if exhausted and (sb + 1) * kb >= n_avail:
            return None, tiles, pruned
        if exhausted:
            sb, c = sb + 1, 0
            found, marg = [-1] * kb, [False] * kb
        else:
            c += 1


def port_walk(k, kb, rb, R, n_avail, nrows, legal, cand):
    """The port's closed form on the same walk: a ``_Chunk`` holding only
    the geometry and the row counts, positions as their own devices."""
    step = _Chunk.__new__(_Chunk)
    step.k, step.kb, step.rb = k, kb, rb
    step.n_sb = -(-k // kb)
    step.k_pad = step.n_sb * kb
    step.pos = torch.arange(step.k_pad)
    step.pos_sb = step.pos // kb
    step.sb_iota = torch.arange(step.n_sb)
    step.dyn = {"nrows": torch.as_tensor(nrows),
                "rows_on": torch.empty((step.k_pad, R))}
    legal = torch.as_tensor(legal) & (step.pos < n_avail)[:, None]
    src_order = step.pos
    n_avail = torch.tensor(n_avail)
    p = torch.where(legal.any(dim=1), step.pos, k).amin()
    ri = (torch.where(legal[min(int(p), step.k_pad - 1)], torch.arange(R),
                      R).amin() % R).view(1)
    geo = (step.frontier(p, ri, n_avail, src_order) if kb > 1 else None)
    cand_src = torch.as_tensor(cand).any(dim=1)
    pruned = step.certified(p, n_avail, cand_src, geo)
    tiles = step.walked(p, ri, n_avail, src_order, torch.tensor([True]),
                        geo)
    win = (int(p), int(ri)) if int(p) < k else None
    return (win, {tuple(t) for t in tiles.nonzero().tolist()},
            set(pruned.nonzero().flatten().tolist()))


@pytest.mark.parametrize("seed", range(4))
def test_closed_form_is_the_reference_walk(seed):
    """On random walks (k, kb, rb, row counts, n_avail from 0 to k, sparse
    legal and candidate rows) the port's winner, tiles and certificates
    are the transcribed loop's, at kb 1 and above."""
    rng = np.random.default_rng(seed)
    for _ in range(150):
        k = int(rng.integers(1, 11))
        kb = int(rng.integers(1, 6))
        kb = min(kb, k)
        rb, nb = int(rng.integers(1, 5)), int(rng.integers(1, 5))
        R = rb * nb
        k_pad = -(-k // kb) * kb
        n_avail = int(rng.integers(0, k + 1))
        nrows = rng.integers(0, R + 1, k_pad)
        real = np.arange(R)[None, :] < nrows[:, None]
        cand = real & (rng.random((k_pad, R)) < rng.random())
        legal = cand & (rng.random((k_pad, R)) < 0.3 * rng.random())
        args = (k, kb, rb, R, n_avail, nrows, legal, cand)
        assert port_walk(*args) == reference_walk(*args), args


# ---------------------------------------------------------------------------
# warm start and absorption at kb 3


def test_warm_sequence_at_source_block_3(reference):
    """The opt-ins' warm sequence at kb 3 with the cache on the small
    cluster (pool growth, a device out and back in, a device add that
    raises k from 16 to 17, a foreign move and a pool create, plans of 10
    at chunk 8 with a stash held): every call equal to the reference
    engine's, one rebuild."""
    recs = lockstep("small_test_cluster", [10] * 8, WARM, chunk=8,
                    legality_cache=True, source_block=3)
    assert sum(r["batch.rebuilds"] for r in recs) == 1


def test_device_add_keeps_the_clamped_source_block(reference):
    """source_block 25 on a 16-device cluster walks one block of k = 16;
    a device add raises k to 17 and kb stays 16, as the reference keeps
    it (two blocks, 15 padding slots), the cache carried across."""
    port_state, ref_state = port_gen.small_test_cluster(), \
        ref_gen.small_test_cluster()
    kw = dict(chunk=8, source_block=25, legality_cache=True,
              source_bounds=False)
    port = BatchPlanner(port_state, device="cpu", **kw)
    ref = ref_batch.BatchPlanner(ref_state, **kw)
    assert counted_plan(port, obs, 6) == counted_plan(ref, ref_obs, 6)
    assert (port._kb, port._step.k_pad) == (16, 16)
    port_state.add_device(Device(id=900, capacity=8 * TiB,
                                 device_class="hdd", host="hx"))
    ref_state.add_device(RefDevice(id=900, capacity=8 * TiB,
                                   device_class="hdd", host="hx"))
    got = counted_plan(port, obs)
    assert got == counted_plan(ref, ref_obs)
    assert (port._kb, port._step.k, port._step.k_pad) == (16, 17, 32)
    assert ref._kb == 16 and got["batch.rebuilds"] == 0


# ---------------------------------------------------------------------------
# the recorder of the cluster-B fixture


def test_recorder_at_source_block_3(reference):
    """``tests/_ref_batch_counters.py``'s recorder at the fixture's config
    with source_block 3 on cluster A gives the reference's row, and the
    port's plan is that row; the committed cluster-B fixture holds runs at
    source_block 3 and 25 with the cache on and off, each of 839 moves,
    1,040 bound hits and 6 pruned sources."""
    cfg = {**CLUSTER_B_CONFIG, "source_block": 3}
    rec = record(ref_gen.cluster_a(), legality_cache=True, **cfg)
    assert (rec["moves"], rec["batch.tiles_walked"], rec["batch.cand_tiles"],
            rec["batch.cache_hits"], rec["batch.cache_misses"]) == (
        44, 218, 172, 8, 210)
    port = counted_plan(BatchPlanner(port_gen.cluster_a(), device="cpu",
                                     legality_cache=True, **cfg), obs)
    assert {"moves": len(port.pop("moves")), **port} == rec
    fixture = json.loads(FIXTURE.read_text())
    assert fixture["config"] == CLUSTER_B_CONFIG
    for kb in (3, 25):
        for cache in (True, False):
            run = fixture["runs"][f"source_block={kb},legality_cache={cache}"]
            assert (run["moves"], run["bound_hits"], run["pruned_sources"]) \
                == (839, 1040, 6)
            assert set(run) == {"moves", "sources_tried_hist", "bound_hits",
                                "pruned_sources", *COUNTERS}
            assert (run["batch.cache_hits"] + run["batch.cache_misses"]
                    == run["batch.tiles_walked"]) is cache


# ---------------------------------------------------------------------------
# repro_torch.core's public names and the deprecated shims

#: names the port exports beyond the reference's, and the reference's
#: names it does not export
PORT_ONLY = {"planners_in_class"}
DROPPED: set[str] = set()
SHIMS = ("equilibrium_balance", "balance_fast", "balance_batch",
         "mgr_balance")


def test_core_exports_match_reference():
    assert set(port_core.__all__) - PORT_ONLY == \
        set(ref_core.__all__) - DROPPED
    assert all(hasattr(port_core, name) for name in port_core.__all__)
    assert port_core.BatchPlanner is BatchPlanner


def _shim_calls(module, compat, name, state, **kw):
    """Two calls of ``module.name``; their first result and the
    DeprecationWarnings they raised, with the warn-once set emptied."""
    compat._WARNED.clear()
    fn = getattr(module, name)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = fn(state, **kw)
        fn(state.copy(), **kw)
    return first, [w for w in caught
                   if issubclass(w.category, DeprecationWarning)]


@pytest.mark.parametrize("name", SHIMS)
def test_shims_warn_once_and_match_reference(monkeypatch, name):
    """Each shim plans what the reference's plans (moves, and the records'
    or trajectory's numbers) and warns once, naming the same replacement."""
    monkeypatch.setattr(ref_compat, "_WARNED", set())
    monkeypatch.setattr(port_compat, "_WARNED", set())
    kw = {"record_trajectory": True}
    port_kw = dict(kw)
    if name == "balance_batch":
        kw.update(source_block=3, row_block=5)
        port_kw.update(kw, device="cpu")
    (want, want_rec), want_w = _shim_calls(ref_core, ref_compat, name,
                                           ref_gen.cluster_a(), **kw)
    (got, got_rec), got_w = _shim_calls(port_core, port_compat, name,
                                        port_gen.cluster_a(), **port_kw)
    assert as_tuples(got) == as_tuples(want) and got
    if name == "mgr_balance":
        assert got_rec == want_rec
    else:
        assert [(r.variance_after, r.sources_tried) for r in got_rec] == \
            [(r.variance_after, r.sources_tried) for r in want_rec]
    assert len(got_w) == len(want_w) == 1
    tail = str(want_w[0].message).split("repro.core.planner.", 1)[1]
    assert str(got_w[0].message).endswith("repro_torch.core.planner." + tail)


def test_no_shim_call_inside_the_port():
    """Nothing under ``src/repro_torch/`` calls a deprecated entry point:
    ``tools/check_deprecated.py`` over the port's root, and a walk of its
    AST for a call of any shim name, however it was imported."""
    root = REPO / "src" / "repro_torch"
    out = subprocess.run([sys.executable, str(REPO / "tools" /
                                              "check_deprecated.py"),
                          "--root", str(root)],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    calls = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call):
                fn = node.func
                name = fn.id if isinstance(fn, ast.Name) else getattr(
                    fn, "attr", None)
                if name in SHIMS:
                    calls.append(f"{path.relative_to(root)}:{node.lineno}")
    assert calls == []
