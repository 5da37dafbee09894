"""K1's fused selection (``select_rows``) in the port against the JAX
package: the port's plain version — what its dispatch runs for CPU
tensors, and what the card's kernel is held to bitwise — equals, bit for
bit, the (k, r_cap, n_dev) legality mask built from the same carry with
the reference's legality core (``repro.core.legality``) in NumPy float64,
as the reference batch engine builds it (a loop over the acting slots),
reduced by the reference's ``masked_select_ref`` under ``jax.enable_x64``.
The carries (``tests/_select_rows_carries.py``) are the first steps of
three paper clusters, the hybrid-rule cluster D among them, with and
without source bounds and with parked sources, plus a knife's edge of the
variance test on each side; and the input the engine gives at
``source_block`` 3, its source positions padded with device 0 and, with
the legality cache, each tile's hit spread over its slots."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _select_rows_carries import (CARRIES, carry, carry_id, engine_cache,
                                  knife_edge, variance_delta)
from repro.core import legality as ref_legality
from repro.kernels.ref import masked_select_ref as ref_masked_select_ref
from repro_torch.kernels import select_move
from repro_torch.kernels.ops import select_rows
from repro_torch.kernels.ref import select_rows_masks, select_rows_ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side: keep torch's
    CPU ops on one thread each so they do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_masks(src_order, n_avail, cap_lim, dyn, const, scal):
    """The JAX package's legality core's (k, R, n) candidate mask and its
    variance test, on NumPy copies of the carry, and the carry's util and
    available sources."""
    src = src_order.numpy()
    dn = {k: v.numpy() for k, v in dyn.items()}
    cn = {k: v.numpy() for k, v in const.items()}
    sc = {k: float(v) for k, v in scal.items()}
    n = dn["used"].shape[0]
    iota = np.arange(n)
    rows_k = dn["rows_on"][src]                               # (k, R)
    k, R = rows_k.shape
    r = np.clip(rows_k, 0, None)
    size = np.where(rows_k >= 0, cn["sh_size"][r], 0.0)
    real = size > 0.0
    pg, lvl, slot = cn["sh_pg"][r], cn["sh_level"][r], cn["sh_slot"][r]
    sbase, scnt, pool = cn["sh_sbase"][r], cn["sh_scnt"][r], cn["sh_pool"][r]
    dev_domain = cn["dev_domain"]

    # static legality, slot by slot as the reference's eval_static does
    dom = dev_domain[lvl]                                     # (k, R, n)
    acting_t = dn["acting"][pg]                               # (k, R, S)
    bad = np.zeros((k, R, n), bool)
    for j in range(acting_t.shape[2]):
        a_j = acting_t[..., j]
        in_step = (j >= sbase) & (j < sbase + scnt) & (j != slot)
        peer_dom = dev_domain[lvl, np.clip(a_j, 0, None)]
        bad |= a_j[..., None] == iota
        bad |= in_step[..., None] & (dom == peer_dom[..., None])
    static = ref_legality.class_ok(cn["sh_class"][r][..., None],
                                   cn["dev_class"][None, None, :]) & ~bad

    cap_lim_ref = ref_legality.capacity_limit(cn["cap"], sc["headroom"])
    assert np.array_equal(cap_lim_ref, cap_lim.numpy())
    cap_ok = ref_legality.capacity_ok(dn["used"][None, None, :], cap_lim_ref,
                                      size[..., None])
    crit = dn["dst_ok"][pool]
    src_ok = ref_legality.src_count_ok(dn["pool_counts"][pool, src[:, None]],
                                       cn["ideal"][pool, src[:, None]],
                                       sc["slack"])
    util = dn["util"]
    u_s = util[src][:, None, None]
    before = ref_legality.before_source(util[None, None, :], u_s,
                                        iota[None, None, :],
                                        src[:, None, None])
    cand = (static & cap_ok & crit & (real & src_ok)[..., None]
            & (iota[None, None, :] != src[:, None, None])
            & cn["dev_in"][None, None, :] & before)
    var_ok = ref_legality.variance_improves(
        dn["used"][src][:, None, None], dn["used"][None, None, :],
        cn["cap"][src][:, None, None], cn["cap"][None, None, :], u_s,
        util[None, None, :], size[..., None], dn["us"], dn["usq"],
        sc["n_f"], sc["min_dvar"])
    return cand, var_ok, util, np.arange(k) < int(n_avail)


def reduce_reference(cand, var_ok, util, avail):
    """(any, dst, cand_src) of reference masks: ``masked_select_ref`` of
    the JAX package under ``jax.enable_x64``."""
    k, R, n = cand.shape
    with jax.enable_x64(True):
        any_r, dst_r = ref_masked_select_ref(
            jnp.asarray((cand & var_ok).reshape(k * R, n)), jnp.asarray(util))
        any_r, dst_r = np.asarray(any_r), np.asarray(dst_r)
    any_r = (any_r.reshape(k, R) & avail[:, None]).reshape(-1)
    return any_r, dst_r, cand.any(axis=(1, 2))


def reference(*args):
    """(any, dst, cand_src) from the JAX package's legality core and
    ``masked_select_ref``, on NumPy copies of the carry."""
    return reduce_reference(*reference_masks(*args))


def assert_matches_reference(args):
    any_p, dst_p, cand_p = select_rows(*args)
    k, R = args[0].shape[0], args[3]["rows_on"].shape[1]
    assert any_p.dtype == torch.bool and any_p.shape == (k * R,)
    assert dst_p.dtype == torch.int32 and dst_p.shape == (k * R,)
    assert cand_p.dtype == torch.bool and cand_p.shape == (k,)
    any_r, dst_r, cand_r = reference(*args)
    assert np.array_equal(any_p.numpy(), any_r)
    # every row, those with no legal destination (dst 0) included
    assert np.array_equal(dst_p.numpy(), dst_r)
    assert np.array_equal(cand_p.numpy(), cand_r)
    return any_p, dst_p


@pytest.mark.parametrize("case", CARRIES, ids=carry_id)
def test_plain_matches_reference(case):
    args = carry(*case)
    any_p, _ = assert_matches_reference(args)
    if case[1] == 0:
        assert any_p.any()              # a first step has a legal move


@pytest.mark.parametrize("cluster,k", [("small_test_cluster", 16),
                                       ("cluster_a", 14), ("cluster_d", 25)])
def test_plain_matches_reference_at_a_padded_source_block(cluster, k):
    """The batch engine's input at source_block 3, where k is not a
    multiple of 3: the positions past k repeat device 0 and lie past
    ``n_avail``, with every third source parked; the plain version
    evaluates them as the reference's mask does and selects none of
    them."""
    args = carry(cluster, 5, True, True, source_block=3)
    src_order, n_avail = args[0], int(args[1])
    assert src_order.shape[0] == -(-k // 3) * 3 > k > n_avail
    assert (src_order[k:] == 0).all()
    any_p, _ = assert_matches_reference(args)
    R = args[3]["rows_on"].shape[1]
    assert not any_p.view(-1, R)[n_avail:].any()


@pytest.mark.parametrize("cluster", ["small_test_cluster", "sim_cluster"])
def test_plain_reads_the_engines_cache_at_a_padded_source_block(cluster):
    """The engine's own cache at source_block 3 on a step where some
    tiles hit and some miss: each tile's hit is spread over its three
    slots, padding slots included; every block read from the cache holds
    the fresh evaluation, and the cached selection is the uncached one
    and the reference's."""
    args, cache = engine_cache(cluster, 60, source_block=3)
    hit = cache["hit_blk"]
    assert torch.equal(hit, hit[::3].repeat_interleave(3, dim=0))
    fresh = select_rows_masks(*args)["cand"]
    hit_rows = hit.repeat_interleave(cache["rb"], 1)
    assert torch.equal(cache["cache_ok"][hit_rows], fresh[hit_rows])
    out = cache["cache_ok"].clone()
    got = select_rows_ref(*args, **cache, cache_out=out, cand_row=True)
    want = select_rows_ref(*args, cand_row=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(out.view_as(fresh), fresh)
    assert_matches_reference(args)


@pytest.mark.parametrize("inside", [False, True], ids=["on", "inside"])
@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_d"])
def test_plain_on_a_knife_edge(cluster, inside):
    """``min_dvar`` = minus the plain version's own variance delta of one
    legal pair: the strict ``<`` rejects that pair on the edge and accepts
    it one ulp inside, and the reference agrees either way."""
    args, (s, r, d) = knife_edge(carry(cluster, 0, True, False), inside)
    edge = args[5]["min_dvar"]
    assert (variance_delta(args, s, r, d) < -edge) == inside
    any_p, dst_p = assert_matches_reference(args)
    m = s * args[3]["rows_on"].shape[1] + r
    if inside:
        assert bool(any_p[m]) and int(dst_p[m]) == d
    else:
        assert not bool(any_p[m]) or int(dst_p[m]) != d


def test_cpu_dispatch_never_launches_the_kernel():
    args = carry("small_test_cluster", 0, True, False)
    select_move.reset_launch_count()
    select_rows(*args)
    assert select_move.launch_counts() == {"select_rows": 0,
                                           "masked_select": 0,
                                           "select_rows_window": 0}
    with pytest.raises(ValueError, match="CUDA"):
        select_move.select_rows_fwd(*args)
