"""The port's host mirror ``DenseState`` against the JAX package's: the
same cluster gives the same arrays, the same candidate and validity
matrices and picks per source, and the same state after applied moves —
the batch engine's carry is built from exactly these arrays."""

import numpy as np
import pytest

from repro.core.clustergen import cluster_a as ref_cluster_a
from repro.core.clustergen import small_test_cluster as ref_small
from repro.core.equilibrium import EquilibriumConfig as RefConfig
from repro.core.equilibrium_jax import DenseState as RefDense
from repro_torch.core.clustergen import cluster_a, small_test_cluster
from repro_torch.core.dense import DenseState
from repro_torch.core.equilibrium import EquilibriumConfig

ARRAYS = ("cap", "used", "dev_class", "dev_in", "dev_domain_arr", "ideal",
          "pool_counts", "sh_pg", "sh_pool", "sh_size", "sh_dev",
          "sh_level", "sh_class", "sh_step", "sh_slot", "sh_sbase",
          "sh_scnt", "member", "occ_dev", "util")


def _same_mirror(ref, port):
    for name in ARRAYS:
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert ref.util_sum == port.util_sum
    assert ref.util_sumsq == port.util_sumsq
    assert ref.shard_key == port.shard_key
    assert ref.rows_on_dev == port.rows_on_dev
    assert ref.class_id == port.class_id and ref.n_domains == port.n_domains


@pytest.mark.parametrize("build", [(ref_small, small_test_cluster),
                                   (ref_cluster_a, cluster_a)])
def test_mirror_masks_and_moves_match_reference(build):
    ref_state, port_state = build[0](), build[1]()
    ref, port = RefDense(ref_state), DenseState(port_state)
    _same_mirror(ref, port)
    rcfg, pcfg = RefConfig(headroom=0.05), EquilibriumConfig(headroom=0.05)
    for _ in range(6):
        order = np.argsort(-port.util, kind="stable")
        picked = None
        for src in order[:8].tolist():
            rows_r, rows_p = ref.source_rows(src), port.source_rows(src)
            assert np.array_equal(rows_r, rows_p)
            v_r = ref.valid_matrix(rows_r, src, rcfg)
            v_p = port.valid_matrix(rows_p, src, pcfg)
            assert np.array_equal(v_r, v_p)
            assert np.array_equal(ref.candidate_matrix(rows_r, src, rcfg),
                                  port.candidate_matrix(rows_p, src, pcfg))
            pick = port.pick(rows_p, v_p)
            assert pick == ref.pick(rows_r, v_r)
            if pick is not None:
                picked = pick
                break
        assert picked is not None
        mv_r = ref.apply_row(*picked)
        mv_p = port.apply_row(*picked)
        assert (mv_r.pg, mv_r.slot, mv_r.src_osd, mv_r.dst_osd, mv_r.size) \
            == (mv_p.pg, mv_p.slot, mv_p.src_osd, mv_p.dst_osd, mv_p.size)
        ref_state.apply(mv_r)
        port_state.apply(mv_p)
        ref.mark_synced()
        port.mark_synced()
        _same_mirror(ref, port)
    port.require_fresh(port_state)
    port_state.grow_pool(0, 1.0)
    assert port.stale
    with pytest.raises(RuntimeError, match="stale"):
        port.require_fresh(port_state)
