"""K2 (flash attention) and K3 (the SSD scan) in the port against the JAX
package.  The port's plain versions — what its dispatch runs for CPU
tensors — agree with the reference's ``flash_attention_ref`` /
``ssd_scan_ref`` and with its Pallas kernels in interpret mode over small
cases of the reference sweeps (tests/test_kernels.py) and, for K3, on
the model's dt and A ramps across several chunks; the kernel wrappers
refuse CPU tensors; and K2's and K3's routes between their two variants
and the TMA layout rule of both hold as pure functions.  The CUDA
kernels are held to the plain
versions in tests/test_torch_cuda.py, which imports no JAX so that it
runs on the card's machine.

Tolerances: float32 1e-5 (the same function summed in another order);
bfloat16 2e-2, the reference suite's own, about two bf16 ulps of outputs
near 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention as jax_flash
from repro.kernels.ops import ssd_scan as jax_ssd
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.ref import ssd_scan_ref as jax_ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd, route
from repro_torch.kernels.ref import (flash_attention_plain,
                                     flash_attention_ref, ssd_chunked,
                                     ssd_scan_plain, ssd_scan_ref)
from repro_torch.kernels.ssd_scan import (K3_RING, ssd_scan_fwd,
                                          workspace_bytes)
from repro_torch.kernels.ssd_scan import route as k3_route
from repro_torch.kernels.tma import check_tma_layout

TOL = {np.float32: dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {np.float32: jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {np.float32: torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side: keep torch's
    CPU ops on one thread each so they do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray, dtype):
    """The same values as a JAX and a torch array of ``dtype``."""
    j = jnp.asarray(a, JNP[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH[dtype])


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# K2


def _qkv(rng, B, T, H, KV, Dh, dtype):
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    return [_pair(a, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("T,Dh,dtype", [
    (32, 16, np.float32),
    (48, 16, np.float32),          # not a multiple of the block
    (32, 32, np.float32),
    (32, 16, "bfloat16"),
])
def test_flash_plain_matches_reference(T, Dh, dtype):
    """Model layout with GQA (H 4, KV 2): the port's dispatch on the CPU
    against the JAX kernel in interpret mode and the JAX plain version."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(np.random.default_rng(0), 2, T, 4,
                                        2, Dh, dtype)
    got = ops.flash_attention(qt, kt, vt)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    ker = jax_flash(qj, kj, vj, block_q=16, block_k=16, interpret=True)
    kf, vf = jnp.repeat(kj, 2, axis=2), jnp.repeat(vj, 2, axis=2)
    flat = [a.transpose(0, 2, 1, 3).reshape(8, T, Dh) for a in (qj, kf, vf)]
    ref = jax_flash_ref(*flat).reshape(2, 4, T, Dh).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(ker), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("window,cap,causal", [
    (None, None, True), (8, None, True), (None, 50.0, True),
    (12, 30.0, True), (None, None, False), (8, None, False),
])
def test_flash_ref_mask_variants(window, cap, causal):
    """The (BH, T, Dh) plain version against the JAX one and the JAX
    kernel (interpret) with each mask and the softcap."""
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((2, 32, 16)).astype(np.float32)
            for _ in range(3)]
    tq, tk, tv = (torch.from_numpy(a) for a in arrs)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    got = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                              cap=cap)
    ref = jax_flash_ref(jq, jk, jv, causal=causal, window=window, cap=cap)
    ker = jax_flash(jq[:, :, None], jk[:, :, None], jv[:, :, None],
                    causal=causal, window=window, cap=cap, block_q=16,
                    block_k=16, interpret=True)[:, :, 0]
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL[np.float32])
    np.testing.assert_allclose(got.numpy(), _np(ker), **TOL[np.float32])


def test_flash_model_attention_matches_plain():
    """The model's CPU path (online softmax over 8-key blocks) equals the
    full-softmax plain version of K2, window and softcap included."""
    from repro_torch.models.layers import attention
    (_, q), (_, k), (_, v) = _qkv(np.random.default_rng(2), 2, 40, 4, 4,
                                  16, np.float32)
    got = attention(q, k, v, causal=True, window=12, cap=30.0, kv_block=8)
    want = flash_attention_plain(q, k, v, causal=True, window=12, cap=30.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL[np.float32])


def test_flash_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 16, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("dtype,Dh,variant", [
    (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 112, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 16, "tensor_core"),
    (torch.float32, 112, "simt"),
    (torch.float32, 64, "simt"),
    (torch.bfloat16, 256, "simt"),
    (torch.bfloat16, 120, "simt"),
    (torch.bfloat16, 8, "simt"),
    (torch.bfloat16, 144, "simt"),
])
def test_flash_route_by_dtype_and_head_dim(dtype, Dh, variant):
    """K2's variant is a function of the dtype and Dh alone: the same
    answer for a contiguous tensor, a strided view and a misaligned one."""
    t = torch.zeros((1, 8, 2, Dh + 1), dtype=dtype)
    for view in (t[..., :Dh].contiguous(), t[..., :Dh], t[..., 1:]):
        assert route(view.dtype, view.shape[-1]) == variant


@pytest.mark.parametrize("ptr,strides,size,ok", [
    (0x7f0000000000, (4096 * 32 * 112, 32 * 112, 112), 2, True),  # zamba2
    (0x7f0000000000, (3 * 64 * 8, 3 * 64, 64), 2, True),  # fused qkv
    (0x7f0000000002, (4096 * 32 * 112, 32 * 112, 112), 2, False),  # +1 elt
    (0x7f0000000008, (4096 * 32 * 112, 32 * 112, 112), 2, False),
    (0x7f0000000000, (4096 * 68, 68, 68), 2, False),  # 136-byte rows
    (0x7f0000000000, (4096 * 64, 64, 0), 2, False),  # broadcast heads
    (0x7f0000000000, (4096 * 64, -64, 64), 2, False),  # flipped T
    (0x7f0000000000, (4096 * 64, 64, 4), 4, True),  # 16-byte stride
    # K3's x, B and C as zamba2's views of xBC (B, T, 7,296) bf16: x (T
    # stride 14,592 bytes, head stride 128), B at 14,336 bytes and C at
    # 14,464 bytes in
    (0x7f0000000000, (4096 * 7296, 7296, 64), 2, True),
    (0x7f0000000000 + 14336, (4096 * 7296, 7296, 64), 2, True),
    (0x7f0000000000 + 14464, (4096 * 7296, 7296, 64), 2, True),
    (0x7f0000000000, (4096 * 112 * 64, 112 * 64, 64), 2, True),  # x alone
    (0x7f0000000002, (4096 * 7296, 7296, 64), 2, False),  # one element off
    (0x7f0000000000, (128 * 644, 644, 64), 2, False),  # 1,288-byte T stride
])
def test_flash_tma_layout_check(ptr, strides, size, ok):
    """The layout rule of the tensor-core kernels (K2's q, k, v and K3's
    x, B, C): pointer and (B, T, head or group) strides positive multiples
    of 16 bytes, or ValueError."""
    if ok:
        check_tma_layout("q", ptr, strides, size)
    else:
        with pytest.raises(ValueError, match="16 bytes"):
            check_tma_layout("q", ptr, strides, size)


# ---------------------------------------------------------------------------
# K3


def _ssd_inputs(rng, B, T, H, G, P, N, dtype, ramp=False):
    """The reference suite's draws; with ``ramp`` the model's dt and A
    (``models/lm.py::_init_leaf``: dt_bias from softplus^-1 of 1e-3 ..
    1e-1 over the heads, plus N(0, 0.5^2) per token; A = -(1 .. 16)),
    under which the state carried across chunks counts."""
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    if ramp:
        bias = np.log(np.expm1(np.exp(np.linspace(np.log(1e-3),
                                                  np.log(1e-1), H))))
        dt = np.log1p(np.exp(bias + 0.5 * rng.standard_normal((B, T, H))))
        A = -np.linspace(1.0, 16.0, H)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, T, H)) - 1))
        A = -np.exp(rng.standard_normal(H) * 0.3)
    dt, A = dt.astype(np.float32), A.astype(np.float32)
    Bm = (rng.standard_normal((B, T, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, T, G, N)) * 0.5).astype(np.float32)
    return ([_pair(a, dtype) for a in (x, dt)] + [_pair(A, np.float32)]
            + [_pair(a, dtype) for a in (Bm, Cm)])


@pytest.mark.parametrize("T,P,N,chunk,dtype", [
    (32, 8, 8, 8, np.float32),
    (32, 16, 8, 16, np.float32),
    (16, 8, 8, 16, np.float32),     # single chunk
    (32, 8, 8, 8, "bfloat16"),
    (256, 64, 128, 128, np.float32),    # mamba2-2.7b's P, N and chunk
])
def test_ssd_plain_matches_reference(T, P, N, chunk, dtype):
    """Model layout with groups (H 4, G 2): the port's dispatch on the
    CPU against the JAX kernel in interpret mode, and the (BH, T, ·)
    plain version against the JAX one, final state included.  At
    mamba2's widths each score sums 128 products and each y 128 keys, 64
    times the depth of the small cases, and the two chunk schedules
    differ by up to 1.7e-5 on outputs near 2: that case is held at 1e-4,
    the tolerance of the float32 kernel on the card."""
    ins = _ssd_inputs(np.random.default_rng(3), 2, T, 4, 2, P, N, dtype)
    (xj, xt), (dj, dtt), (aj, at), (bj, bt), (cj, ct) = ins
    got = ops.ssd_scan(xt, dtt, at, bt, ct, chunk=chunk)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    ker = jax_ssd(xj, dj, aj, bj, cj, chunk=chunk, interpret=True)
    deep = dtype == np.float32 and chunk * N > 1024
    np.testing.assert_allclose(_np(got), _np(ker),
                               **(dict(rtol=1e-4, atol=1e-4) if deep
                                  else TOL[dtype]))

    BH = 8
    flat = dict(x=xt.float().transpose(1, 2).reshape(BH, T, P),
                dt=dtt.float().transpose(1, 2).reshape(BH, T),
                A=at.repeat(2),
                Bm=bt.float().repeat_interleave(2, 2).transpose(1, 2)
                .reshape(BH, T, N),
                Cm=ct.float().repeat_interleave(2, 2).transpose(1, 2)
                .reshape(BH, T, N))
    y, h = ssd_scan_ref(**flat)
    y_r, h_r = jax_ssd_ref(*(jnp.asarray(v.numpy()) for v in flat.values()))
    np.testing.assert_allclose(y.numpy(), _np(y_r), **TOL[np.float32])
    np.testing.assert_allclose(h.numpy(), _np(h_r), **TOL[np.float32])


def test_ssd_chunked_matches_reference_and_token_scan():
    """The model's plain chunk loop against the reference's
    ``ssd_chunked`` (y and final state) and the port's token-level
    recurrence."""
    ins = _ssd_inputs(np.random.default_rng(4), 2, 64, 4, 1, 16, 16,
                      np.float32)
    jx, tx = zip(*ins)
    y, state = ssd_chunked(*tx, 16)
    y_r, state_r = jax_ssd_chunked(*jx, chunk=16, superchunk=2)
    np.testing.assert_allclose(y.numpy(), _np(y_r), **TOL[np.float32])
    np.testing.assert_allclose(state.numpy(), _np(state_r),
                               **TOL[np.float32])
    np.testing.assert_allclose(y.numpy(), ssd_scan_plain(*tx).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_ssd_wrapper_refuses_cpu_tensors():
    ins = [t for _, t in _ssd_inputs(np.random.default_rng(5), 1, 16, 2, 1,
                                     4, 4, np.float32)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_fwd(*ins, chunk=16)


@pytest.mark.parametrize("T,chunk,dtype,P,N", [
    pytest.param(64, 16, np.float32, 16, 8, id="64-16-float32"),  # 4 chunks
    pytest.param(128, 16, np.float32, 16, 8, id="128-16-float32"),
    pytest.param(128, 32, "bfloat16", 16, 8, id="128-32-bfloat16"),
    # mamba2-2.7b's P, N and chunk over two chunks
    pytest.param(256, 128, np.float32, 64, 128, id="256-128-float32-N128"),
])
def test_ssd_chunked_matches_kernel_on_ramps(T, chunk, dtype, P, N):
    """The port's plain chunk loop against the JAX kernel in interpret
    mode on the model's dt and A ramps, groups included (H 4, G 2): the
    carried state is not negligible there (with the suite's draws it
    decays to about e^-50 per chunk of 128 and hides a dropped state)."""
    ins = _ssd_inputs(np.random.default_rng(6), 2, T, 4, 2, P, N, dtype,
                      ramp=True)
    (xj, xt), (dj, dtt), (aj, at), (bj, bt), (cj, ct) = ins
    y, state = ssd_chunked(xt, dtt, at, bt, ct, chunk)
    ker = jax_ssd(xj, dj, aj, bj, cj, chunk=chunk, interpret=True)
    np.testing.assert_allclose(_np(y), _np(ker), **TOL[dtype])
    # the carried state matters on these inputs: dropping it at every
    # chunk boundary changes y by far more than the tolerance
    dropped = torch.cat([ssd_chunked(*(t[:, c:c + chunk] for t in
                                       (xt, dtt)), at,
                                     bt[:, c:c + chunk], ct[:, c:c + chunk],
                                     chunk)[0]
                         for c in range(0, T, chunk)], dim=1)
    assert float((dropped.float() - y.float()).abs().max()) > 0.05
    assert float(state.abs().max()) > 0.1


@pytest.mark.parametrize("dtype,P,N,chunk,variant", [
    (torch.bfloat16, 64, 64, 128, "tensor_core"),
    (torch.bfloat16, 64, 64, 64, "tensor_core"),
    (torch.float32, 64, 64, 128, "simt"),
    (torch.bfloat16, 16, 16, 16, "simt"),        # reduced configs
    (torch.bfloat16, 64, 64, 32, "simt"),        # T 32 cuts the chunk
    (torch.bfloat16, 64, 64, 100, "simt"),
    (torch.bfloat16, 128, 64, 128, "simt"),
    (torch.bfloat16, 64, 128, 128, "tensor_core"),   # mamba2-2.7b's call
    (torch.float16, 64, 64, 128, "simt"),
    (torch.bfloat16, 64, 128, 64, "tensor_core"),
    (torch.bfloat16, 64, 256, 128, "simt"),
    (torch.bfloat16, 128, 128, 128, "simt"),
    (torch.float32, 64, 128, 128, "simt"),
])
def test_ssd_route_by_dtype_and_widths(dtype, P, N, chunk, variant):
    """K3's variant is a function of the dtype, P, N and the chunk alone."""
    assert k3_route(dtype, P, N, chunk) == variant


def test_ssd_workspace_does_not_grow_with_t():
    """The tensor-core call's workspace is the hand-off ring (K3_RING
    float32 (P, N) slots per (batch, head)) and one counter per (batch,
    head) plus the ticket: the same at T 4,096 and 32,768, 3.7 MB at the
    zamba2 cell (B 1, H 112) and at most 128 MB at the registry's
    prefill_32k (B 32), where one slot per chunk took 15.0 GB."""
    for B, H in ((1, 112), (32, 112), (2, 4)):
        ring = B * H * K3_RING * 64 * 64 * 4 + (B * H + 1) * 4
        for T in (4096, 32768):
            assert workspace_bytes(B, H, T, 64, 64, 128) == ring
    assert K3_RING == 2
    assert workspace_bytes(1, 112, 4096, 64, 64, 128) == 3_670_468
    assert workspace_bytes(32, 112, 32768, 64, 64, 128) <= 128 * 2 ** 20


@pytest.mark.parametrize("T", [4096, 32768])
def test_ssd_workspace_at_the_mamba2_cell(T):
    """mamba2-2.7b's tensor-core call (B 1, H 80, P 64, N 128, chunk
    128): two float32 (64, 128) slots and one counter per head, plus the
    ticket, whatever T."""
    assert workspace_bytes(1, 80, T, 64, 128, 128) == \
        1 * 80 * 2 * 64 * 128 * 4 + 81 * 4 == 5_243_204
