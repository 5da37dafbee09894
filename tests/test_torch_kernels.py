"""K1 (the masked move-selection reduction) in the port against the JAX
package: the port's plain version — what its dispatch runs for CPU
tensors — equals the reference's ``masked_select_ref`` and its Pallas
kernel in interpret mode, bitwise, over the reference sweep
(tests/test_kernels.py) in float32, plus float64 under
``jax.enable_x64``; the source-queue stable partition keeps its
property; and, where a card is present, the CUDA kernel equals the
plain version bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import masked_select as ref_masked_select
from repro.kernels.ref import masked_select_ref as ref_masked_select_ref
from repro_torch.kernels import select_move
from repro_torch.kernels.ops import masked_select
from repro_torch.kernels.ref import masked_select_ref
from repro_torch.kernels.select_move import compact_parked, compact_sources

SWEEP = [(8, 16, 256), (200, 995, 256), (100, 300, 32), (1, 1, 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side: keep torch's
    CPU ops on one thread each so they do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(valid, util, block_rows):
    """(any, dst) from the JAX package's plain version and its kernel in
    interpret mode, as NumPy arrays."""
    v, u = jnp.asarray(valid), jnp.asarray(util)
    any_r, dst_r = ref_masked_select_ref(v, u)
    any_k, dst_k = ref_masked_select(v, u, block_rows=block_rows,
                                     interpret=True)
    return (np.asarray(any_r), np.asarray(dst_r),
            np.asarray(any_k), np.asarray(dst_k))


def _port(valid, util):
    any_p, dst_p = masked_select(torch.from_numpy(valid),
                                 torch.from_numpy(util))
    assert any_p.dtype == torch.bool and dst_p.dtype == torch.int32
    return any_p.numpy(), dst_p.numpy()


@pytest.mark.parametrize("M,D,block_rows", SWEEP)
@pytest.mark.parametrize("density", [0.05, 0.5])
def test_plain_matches_reference_float32(M, D, block_rows, density):
    rng = np.random.default_rng(42)
    valid = rng.random((M, D)) < density
    util = rng.random(D).astype(np.float32)
    any_r, dst_r, any_k, dst_k = _reference(valid, util, block_rows)
    any_p, dst_p = _port(valid, util)
    assert np.array_equal(any_p, any_r) and np.array_equal(any_p, any_k)
    # every row, including those with no legal destination (dst 0)
    assert np.array_equal(dst_p, dst_r)
    assert np.array_equal(dst_p[any_k], dst_k[any_k])


@pytest.mark.parametrize("M,D,block_rows", SWEEP)
def test_plain_matches_reference_float64(M, D, block_rows):
    """The planner path runs util in float64; the reference is evaluated
    under ``jax.enable_x64`` so it keeps float64 too."""
    rng = np.random.default_rng(7)
    valid = rng.random((M, D)) < 0.05
    util = rng.random(D)
    util[: D // 3] = util[0]                   # many exact ties
    with jax.enable_x64(True):
        assert jnp.asarray(util).dtype == jnp.float64
        any_r, dst_r, any_k, dst_k = _reference(valid, util, block_rows)
    any_p, dst_p = _port(valid, util)
    assert np.array_equal(any_p, any_r) and np.array_equal(any_p, any_k)
    assert np.array_equal(dst_p, dst_r)
    assert np.array_equal(dst_p[any_k], dst_k[any_k])
    masked = np.where(valid, util[None, :], np.inf)
    assert np.array_equal(dst_p, np.argmin(masked, axis=1))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tie_break_lowest_index(dtype):
    valid = np.array([[True, True, True, False]])
    util = np.array([0.5, 0.2, 0.2, 0.0], dtype)
    any_p, dst_p = _port(valid, util)
    assert any_p[0] and dst_p[0] == 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_all_invalid_rows_give_dst_zero(dtype):
    for M, D in ((3, 7), (1, 1)):
        valid = np.zeros((M, D), bool)
        util = np.linspace(1, 0, D).astype(dtype)
        any_p, dst_p = _port(valid, util)
        assert not any_p.any() and not dst_p.any()


def test_cpu_dispatch_never_launches_the_kernel():
    select_move.reset_launch_count()
    masked_select(torch.ones((2, 3), dtype=torch.bool),
                  torch.zeros(3, dtype=torch.float64))
    assert select_move.launch_count() == 0
    with pytest.raises(ValueError, match="CUDA"):
        select_move.masked_select_fwd(torch.ones((2, 3), dtype=torch.bool),
                                      torch.zeros(3, dtype=torch.float64))


def test_compact_sources_stable_partition():
    rng = np.random.default_rng(0)
    for _ in range(25):
        n = int(rng.integers(4, 40))
        k = int(rng.integers(1, n + 1))
        order = rng.permutation(n)[:k]
        pruned = rng.random(n) < rng.uniform(0, 1)
        comp, count = compact_sources(torch.from_numpy(order),
                                      torch.from_numpy(pruned))
        expected = ([d for d in order.tolist() if not pruned[d]]
                    + [d for d in order.tolist() if pruned[d]])
        assert comp.tolist() == expected
        assert int(count) == sum(not pruned[d] for d in order.tolist())


def test_compact_parked_edges():
    order = torch.tensor([4, 2, 9])
    for parked, want in (([False] * 3, [4, 2, 9]), ([True] * 3, [4, 2, 9]),
                         ([True, False, True], [2, 4, 9])):
        comp, count = compact_parked(order, torch.tensor(parked))
        assert comp.tolist() == want
        assert int(count) == parked.count(False)


@pytest.mark.cuda
def test_k1_matches_plain_on_cuda():
    """The hand-written kernel against its plain version on the card,
    bitwise, including rows with no legal destination."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    for dtype in (np.float32, np.float64):
        for M, D, dens in ((4600, 995, 0.05), (64, 7960, 0.5), (3, 7, 0.0)):
            v = torch.as_tensor(rng.random((M, D)) < dens, device="cuda")
            u = torch.as_tensor(rng.random(D).astype(dtype), device="cuda")
            before = select_move.launch_count()
            any_k, dst_k = masked_select(v, u)
            assert select_move.launch_count() == before + 1
            any_p, dst_p = masked_select_ref(v, u)
            assert torch.equal(any_k, any_p) and torch.equal(dst_k, dst_p)
