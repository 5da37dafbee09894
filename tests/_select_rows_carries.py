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
accepted).  Imports no JAX: the card's tests use it too.
"""

import torch

from repro_torch.core import clustergen
from repro_torch.core.equilibrium_batch import BatchPlanner
from repro_torch.kernels.ref import select_rows_ref

CLUSTERS = ("small_test_cluster", "cluster_a", "cluster_d")
#: (steps run before, source bounds, parked)
STATES = ((0, False, False), (0, True, True), (5, True, False),
          (5, True, True), (5, False, False))
CARRIES = [(c, *st) for c in CLUSTERS for st in STATES]


def carry_id(case) -> str:
    cluster, steps, bounds, parked = case
    return (f"{cluster}-step{steps}-{'bounds' if bounds else 'nobounds'}"
            f"{'-parked' if parked else ''}")


def carry(cluster: str, steps: int, bounds: bool, parked: bool) -> tuple:
    """The arguments of ``select_rows`` (src_order, n_avail, cap_lim, dyn,
    const, scal), on the CPU."""
    planner = BatchPlanner(getattr(clustergen, cluster)(),
                           chunk=max(steps, 1), source_bounds=bounds,
                           device="cpu")
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
