"""Carries of the batched planner's step for the tests of K1's fused
selection (``select_rows``), built by the port's own engine on the CPU.

A carry is a paper cluster's ``_Chunk`` after ``steps`` planning steps,
with its top-k sources as the step scans them: all k available without
source bounds; under bounds, the unpruned first and, with ``parked``,
every third of the top-k marked pruned as well, so that ``n_avail < k``.
Every row table has ``-1`` padding (``r_cap`` = the fullest device's rows
plus a chunk), and ``small_test_cluster``'s two-slot pool pads its acting
rows; ``cluster_d`` has the paper's hybrid rule (1 x ssd + 2 x hdd).

The knife's edge sets ``min_dvar`` from the plain version's own variance
delta of one legal pair, so that the test's strict ``<`` sits exactly on
that pair's boundary (the pair is rejected) or one ulp inside it (it is
accepted).

The legality cache's states (``cache_states``, ``engine_cache``): every
block a miss, every block a hit on the fresh masks, a tag mismatch
(every other source's blocks hit, the others' bytes noise), and the
engine's own cache after planning steps with it on.  Imports no JAX: the
card's tests and ``chip_smoke.py`` use it too.
"""

import functools

import torch

from repro_torch.core import ClusterState, clustergen
from repro_torch.core.equilibrium_batch import BatchPlanner
from repro_torch.kernels.ref import select_rows_masks, select_rows_ref

CLUSTERS = ("small_test_cluster", "cluster_a", "cluster_d")
#: (steps run before, source bounds, parked)
STATES = ((0, False, False), (0, True, True), (5, True, False),
          (5, True, True), (5, False, False))
CARRIES = [(c, *st) for c in CLUSTERS for st in STATES]


def carry_id(case) -> str:
    cluster, steps, bounds, parked = case
    return (f"{cluster}-step{steps}-{'bounds' if bounds else 'nobounds'}"
            f"{'-parked' if parked else ''}")


@functools.lru_cache(maxsize=None)
def _built(cluster: str) -> dict:
    return getattr(clustergen, cluster)().to_plain()


def cluster_state(cluster: str) -> ClusterState:
    """A new state of the paper cluster ``cluster``, equal to a fresh
    build (the build runs once a process; each call rebuilds the state
    from its plain form, bytes as they are)."""
    return ClusterState.from_plain(_built(cluster))


def carry(cluster: str, steps: int, bounds: bool, parked: bool,
          source_block: int = 1) -> tuple:
    """The arguments of ``select_rows`` (src_order, n_avail, cap_lim, dyn,
    const, scal), on the CPU; at a ``source_block`` that does not divide
    k, ``src_order`` is padded with device 0 to a whole number of
    blocks."""
    planner = BatchPlanner(cluster_state(cluster),
                           chunk=max(steps, 1), source_bounds=bounds,
                           source_block=source_block, device="cpu")
    planner.sync()
    step = planner._step
    if steps:
        step.run(steps)
    if parked:
        order_k = step.dyn["order"][:step.k]
        step.dyn["pruned"][order_k[1::3]] = True
    _, src_order, n_avail = step.sources()
    if parked:
        assert int(n_avail) < step.k
    return src_order, n_avail, step.cap_lim, step.dyn, step.const, step.scal


def to_device(args: tuple, device) -> tuple:
    """``args`` with every tensor, the carry's dicts' too, on ``device``."""
    def move(x):
        if isinstance(x, dict):
            return {k: v.to(device) for k, v in x.items()}
        return x.to(device)
    return tuple(move(x) for x in args)


def variance_delta(args: tuple, s: int, r: int, d: int) -> torch.Tensor:
    """new_var - old_var of moving source position ``s``'s row ``r`` to
    device ``d``: ``legality.variance_improves``'s expression in its
    operand order, as a 0-dim float64 tensor."""
    src_order, _, _, dyn, const, scal = args
    src = int(src_order[s])
    size = const["sh_size"][int(dyn["rows_on"][src, r])]
    used, util, cap = dyn["used"], dyn["util"], const["cap"]
    us, usq, n = dyn["us"][0], dyn["usq"][0], scal["n_f"]
    v_s = (used[src] - size) / cap[src]
    v_d = (used[d] + size) / cap[d]
    dsum = (v_s - util[src]) + (v_d - util[d])
    dsq = (v_s ** 2 - util[src] ** 2) + (v_d ** 2 - util[d] ** 2)
    new_var = (usq + dsq) / n - ((us + dsum) / n) ** 2
    old_var = usq / n - (us / n) ** 2
    return new_var - old_var


def knife_edge(args: tuple, inside: bool) -> tuple[tuple, tuple]:
    """(``args`` with ``min_dvar`` on the knife's edge of the first legal
    pair, that pair (s, r, d)).  ``inside=False``: ``-min_dvar`` equals the
    pair's variance delta, which the strict ``<`` rejects; ``True``: one
    ulp beyond it, which accepts."""
    any_row, dst, _ = select_rows_ref(*args)
    m = int(torch.nonzero(any_row)[0])
    r_cap = args[3]["rows_on"].shape[1]
    s, r, d = m // r_cap, m % r_cap, int(dst[m])
    edge = -variance_delta(args, s, r, d)
    if inside:
        edge = torch.nextafter(edge, torch.tensor(float("-inf"),
                                                  dtype=edge.dtype))
    scal = {**args[5], "min_dvar": edge.to(args[5]["min_dvar"].device)}
    return (*args[:5], scal), (s, r, d)


#: the legality cache's row block in the cache states
CACHE_RB = 8


def cache_states(args: tuple) -> list[tuple[str, dict, torch.Tensor]]:
    """(name, the cache's arguments, the fresh candidate masks) of each
    cache state for one carry: ``miss`` (nothing clean, the bytes noise),
    ``hit`` (every block clean on the fresh masks), ``tag-mismatch``
    (every other source's blocks clean, the others' bytes noise).  The
    cached call must give the uncached call's outputs and write the fresh
    masks into its miss rows."""
    fresh = select_rows_masks(*args)["cand"]
    k, R, n = fresh.shape
    dev = fresh.device
    rb = CACHE_RB
    gen = torch.Generator().manual_seed(0)
    noise = (torch.rand((k, R, n), generator=gen) < 0.3).to(dev)
    odd = (torch.arange(k, device=dev) % 2 == 1)[:, None].expand(
        k, R // rb).contiguous()
    blocks = (k, R // rb, rb, n)
    mixed = torch.where(odd[:, :, None, None], fresh.view(blocks),
                        noise.view(blocks)).view(k, R, n)
    return [("miss", dict(cache_ok=noise, hit_blk=torch.zeros_like(odd),
                          rb=rb), fresh),
            ("hit", dict(cache_ok=fresh.clone(),
                         hit_blk=torch.ones_like(odd), rb=rb), fresh),
            ("tag-mismatch", dict(cache_ok=mixed, hit_blk=odd, rb=rb),
             fresh)]


def engine_cache(cluster: str, steps: int, legal_hit: bool = False,
                 device="cpu", source_block: int = 1) -> tuple[tuple, dict]:
    """The engine's carry with the legality cache on after its first step
    (at most ``steps``, chunk 1) after which the next step reads some
    blocks from the cache and evaluates others (with ``legal_hit``: reads
    a legal pair from it): that step's ``select_rows`` arguments and its
    cache, as the step reads them (at a ``source_block`` above 1, the
    padded sources and each tile's hit spread over its slots)."""
    planner = BatchPlanner(cluster_state(cluster), chunk=1,
                           legality_cache=True, source_block=source_block,
                           device=device)
    planner.sync()
    step = planner._step
    d = step.dyn
    for _ in range(steps):
        step.run(1)
        _, src_order, n_avail = step.sources()
        args = (src_order, n_avail, step.cap_lim, d, step.const, step.scal)
        _, hit_blk, _ = step.hits(src_order)
        hit_rows = hit_blk.repeat_interleave(step.rb, 1)
        legal = select_rows_ref(*args)[0].view(step.k_pad, -1) & hit_rows
        if bool(hit_blk.any()) and not bool(hit_blk.all()) \
                and (bool(legal.any()) or not legal_hit):
            return args, dict(cache_ok=d["c_ok"].clone(), hit_blk=hit_blk,
                              rb=step.rb)
    raise AssertionError(f"{cluster}: no such step in {steps}")


def window_args(args: tuple, ways: int, rank: int) -> tuple[tuple, int]:
    """(the arguments of K1's window form for window ``rank`` of ``ways``
    of a carry, its base): the carry ``args`` (``select_rows``') split as
    the sharded engine splits it (``shard.partition_carry``, the device
    axis padded to a multiple of ``ways``), and the step's gathered
    tensors taken from the whole carry — the sources' rows, their packed
    records, their PGs' acting sets and the source-count criterion."""
    from repro_torch.core import legality
    from repro_torch.core.shard import partition_carry
    from repro_torch.kernels.ref import pack_records
    src_order, n_avail, _, dyn, const, scal = args
    rows_k = dyn["rows_on"][src_order]
    rec = pack_records(const)[rows_k.clamp(min=0)]
    act_k = dyn["acting"][rec[..., 0]]
    pool, src = rec[..., 1], src_order[:, None]
    src_ok = legality.src_count_ok(dyn["pool_counts"][pool, src],
                                   const["ideal"][pool, src], scal["slack"])
    n = const["cap"].shape[0]
    width = -(-n // ways) * ways
    dyn_w, const_w, _ = partition_carry(dyn, const, ways, rank, width)
    cap_lim = legality.capacity_limit(const_w["cap"], scal["headroom"])
    base = rank * (width // ways)
    return (src_order, n_avail, rows_k, rec, act_k.contiguous(), src_ok,
            cap_lim, dyn_w, const_w, scal), base


def fold_windows(outs: list[tuple], avail: torch.Tensor) -> tuple:
    """The windows' (any, dst, cand_src) folded in ascending window order
    as the sharded engine folds its ranks' (the legality core's
    ``shard_winner_better`` on (any, util at dst, dst)), then ``any``
    masked by the (k,) available positions: ``outs[i]`` is (any, dst,
    cand_src, util) of window i launched with every position available,
    ``util`` the padded carry's."""
    from repro_torch.core import legality
    any_row, dst, cand_src, util = outs[0]
    dst = dst.to(torch.int64)
    usel = util[dst]
    for a, d, c, _ in outs[1:]:
        d = d.to(torch.int64)
        better = legality.shard_winner_better(a, util[d], d, any_row, usel,
                                              dst)
        usel = torch.where(better, util[d], usel)
        dst = torch.where(better, d, dst)
        any_row = any_row | a
        cand_src = cand_src | c
    any_row = (any_row.view(avail.shape[0], -1) & avail[:, None]).view(-1)
    return any_row, dst.to(torch.int32), cand_src
