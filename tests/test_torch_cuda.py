"""The port's CUDA kernels K1's fused selection (``select_rows``), K2
(flash attention) and K3 (the SSD scan) against their plain versions,
and the LM prefill through them against the same parameters on the CPU.  Every test needs a card (``cuda``
marker) and skips without one; the file imports no JAX, so it runs
where the card is:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4 (another summation order, and the model's
products in full float32 on both sides); bfloat16 2e-2, about two bf16
ulps of outputs near 1.  K2's tensor-core variant (bf16) is also held to
the float32 plain version of the same bf16 inputs: each output row
within 1e-2 relative L2 error (bf16 rounds the output and P to 2^-9, a
fifth of that; a key tile dropped from a row of up to 4,096 keys costs
at least sqrt(128 / 4096) = 0.18), and, at a reduced prefill shape,
within twice the error of ``scaled_dot_product_attention``.  K3's
tensor-core variant (bf16, P 64, N 64 and mamba2-2.7b's 128) is held
the same way to the float32 plain version, each (token, head) row
within 1e-2, and within 4 x the SIMT variant's error on the same inputs.
The SIMT K3 at state widths 128 (in float32) and 256 (the widest the
block fits) is held to the float32 plain version at 1e-4 in float32 and,
in bf16, per row at 1e-2.  ``select_rows`` is held bitwise to ``select_rows_ref`` on
the planner carries of ``tests/_select_rows_carries.py``, the knife's
edge of the variance test on each side among them."""

import numpy as np
import pytest
import torch

from _select_rows_carries import (CARRIES, carry, carry_id, knife_edge,
                                  to_device)
from repro_torch.kernels import flash_attention as k2
from repro_torch.kernels import select_move
from repro_torch.kernels import ssd_scan as k3
from repro_torch.kernels.ref import (flash_attention_plain, select_rows_ref,
                                     ssd_scan_plain)
from repro_torch.models.lm import ssd_ramps

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    t = 1e-4 if dtype == torch.float32 else 2e-2
    return dict(rtol=t, atol=t)


#: the largest relative L2 error of one K2 output row (over Dh) that a
#: bf16 call may have against the float32 plain version
ROW_REL_TOL = 1e-2


def _errors(got, want):
    """(max abs error, max relative L2 error of a row over Dh)."""
    d = got.float() - want
    row = d.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-6)
    return float(d.abs().max()), float(row.max())


def _f32_plain(q, k, v, **kw):
    """The plain version on float32 copies of the same bf16 inputs."""
    return flash_attention_plain(q.float(), k.float(), v.float(), **kw)


@pytest.mark.parametrize("T,Dh,KV,window,cap,causal,dtype", [
    (128, 64, 2, None, None, True, torch.float32),
    (96, 112, 4, None, None, True, torch.float32),
    (200, 256, 4, 48, 30.0, True, torch.float32),
    (256, 64, 4, None, None, False, torch.float32),
    (256, 128, 4, 70, None, False, torch.float32),
    (256, 112, 4, None, None, True, torch.bfloat16),
])
def test_k2_matches_plain(card, T, Dh, KV, window, cap, causal, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn((2, T, h, Dh), generator=g, device=card).to(dtype)
               for h in (4, KV, KV))
    got = k2.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 cap=cap)
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 cap=cap)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("T,H,KV,Dh,window,cap,causal", [
    (256, 4, 4, 64, None, None, True),
    (256, 4, 4, 112, None, None, True),
    (256, 4, 4, 128, None, None, True),
    (256, 8, 2, 112, None, None, True),         # GQA
    (384, 4, 4, 112, 48, 30.0, True),           # window and softcap
    (256, 4, 4, 64, None, None, False),         # non-causal
    (200, 4, 2, 112, None, None, True),         # ragged T
    (1024, 2, 2, 112, 100, None, True),         # window skips whole tiles
    (1024, 2, 2, 128, 100, None, False),
    (200, 4, 2, 16, None, None, True),          # box wider than Dh
    (200, 4, 2, 48, 70, None, True),
])
def test_k2_tensor_core_matches_float32_plain(card, T, H, KV, Dh, window,
                                              cap, causal):
    """bf16 calls take the tensor-core variant and agree with the float32
    plain version of the same bf16 inputs."""
    g = torch.Generator(device=card).manual_seed(2)
    q, k, v = (torch.randn((2, T, h, Dh), generator=g,
                           device=card).to(torch.bfloat16)
               for h in (H, KV, KV))
    kw = dict(causal=causal, window=window, cap=cap)
    k2.reset_launch_count()
    got = k2.flash_attention_fwd(q, k, v, **kw)
    assert k2.launch_counts() == {"tensor_core": 1, "simt": 0}
    want = _f32_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want, **_tol(torch.bfloat16))
    assert _errors(got, want)[1] <= ROW_REL_TOL


def test_k2_tensor_core_within_twice_sdpa(card):
    """Reduced prefill shape (T 1024, H 8, Dh 112, causal): against the
    float32 plain version, K2's max abs error and worst row error are at
    most twice those of scaled_dot_product_attention on the same bf16
    inputs."""
    import torch.nn.functional as F
    g = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn((1, 1024, 8, 112), generator=g,
                           device=card).to(torch.bfloat16) for _ in range(3))
    want = _f32_plain(q, k, v)
    lib = F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in (q, k, v)), is_causal=True)
    k2_abs, k2_row = _errors(k2.flash_attention_fwd(q, k, v), want)
    lib_abs, lib_row = _errors(lib.transpose(1, 2), want)
    assert k2_abs <= 2 * lib_abs and k2_row <= 2 * lib_row, \
        (k2_abs, lib_abs, k2_row, lib_row)


def test_k2_misaligned_bf16_raises(card):
    """A bf16 call that TMA cannot read raises; it never goes to the SIMT
    variant."""
    buf = torch.randn(2 * 64 * 4 * 64 + 1, device=card).to(torch.bfloat16)
    shifted = buf[1:].view(2, 64, 4, 64)        # one element off 16 bytes
    wide = torch.randn((2, 64, 4, 68), device=card).to(torch.bfloat16)
    k2.reset_launch_count()
    for q in (shifted, wide[..., :64]):
        with pytest.raises(ValueError, match="16 bytes"):
            k2.flash_attention_fwd(q, q, q)
    assert k2.launch_count() == 0


def test_k2_float32_takes_simt(card):
    q = torch.randn((1, 128, 2, 112), device=card)
    k2.reset_launch_count()
    k2.flash_attention_fwd(q, q, q)
    assert k2.launch_counts() == {"tensor_core": 0, "simt": 1}


def test_k2_reads_strided_views(card):
    """q, k and v as column slices of one fused projection, unit stride
    over Dh only: the kernel reads the strides, no copy is made."""
    g = torch.Generator(device=card).manual_seed(1)
    qkv = torch.randn((2, 64, 3, 4, 32), generator=g, device=card)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    torch.testing.assert_close(k2.flash_attention_fwd(q, k, v),
                               flash_attention_plain(q, k, v),
                               **_tol(torch.float32))


def _ssd_inputs(card, B, T, H, G, P, N, dtype, seed=0, ramp=False):
    """The reference suite's draws, or with ``ramp`` the model's dt and A
    ramps (dt about 1e-3 .. 1e-1 over the heads, A = -(1 .. 16)), under
    which the carried state survives a chunk."""
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((B, T, H, P), generator=g, device=card)
    if ramp:
        dt_h, A = ssd_ramps(H, device=card)
        dt = torch.nn.functional.softplus(
            torch.log(torch.expm1(dt_h))
            + 0.5 * torch.randn((B, T, H), generator=g, device=card))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((B, T, H), generator=g, device=card) - 1)
        A = -torch.exp(torch.randn((H,), generator=g, device=card) * 0.3)
    Bm = torch.randn((B, T, G, N), generator=g, device=card) * 0.5
    Cm = torch.randn((B, T, G, N), generator=g, device=card) * 0.5
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


def _xbc_views(card, T, H, dtype, pad=0, ramp=True, N=64):
    """x, dt, A, B, C with x, B and C as the SSD layer passes them: views
    into one (1, T, 64 H + 2 N + pad) xBC tensor, P 64, G 1."""
    g = torch.Generator(device=card).manual_seed(4)
    xbc = torch.randn((1, T, 64 * H + 2 * N + pad), generator=g,
                      device=card).to(dtype)
    x, Bm, Cm, _ = torch.split(xbc, [64 * H, N, N, pad], dim=-1)
    _, dt, A, _, _ = _ssd_inputs(card, 1, T, H, 1, 64, N, dtype, ramp=ramp)
    return (x.reshape(1, T, H, 64), dt, A, Bm.reshape(1, T, 1, N),
            Cm.reshape(1, T, 1, N))


@pytest.mark.parametrize("T,P,N,chunk,G,dtype", [
    (256, 64, 64, 128, 1, torch.float32),
    (128, 16, 16, 32, 2, torch.float32),
    (64, 16, 16, 64, 4, torch.float32),
    (256, 64, 64, 128, 1, torch.bfloat16),
    (256, 64, 64, 32, 1, torch.bfloat16),       # bf16 on the SIMT variant
    (200, 100, 36, 100, 2, torch.float32),      # P over two blocks, ragged
])
def test_k3_matches_plain(card, T, P, N, chunk, G, dtype):
    ins = _ssd_inputs(card, 2, T, 4, G, P, N, dtype)
    got = k3.ssd_scan_fwd(*ins, chunk=chunk)
    torch.testing.assert_close(got.float(), ssd_scan_plain(*ins).float(),
                               **_tol(dtype))


@pytest.mark.parametrize("T,H,G,chunk,ramp", [
    (256, 4, 1, 128, False),
    (256, 4, 1, 128, True),
    (1024, 8, 2, 128, True),        # 8 chunks, two groups
    (512, 16, 4, 64, True),         # chunk 64, 8 chunks, four groups
    (64, 4, 1, 64, False),          # one chunk
])
def test_k3_tensor_core_matches_float32_plain(card, T, H, G, chunk, ramp):
    """bf16 calls with P = N = 64 take the tensor-core variant and agree
    with the float32 plain version of the same bf16 inputs, each (token,
    head) row within 1e-2 relative L2; the ramps make the state carried
    across chunks count."""
    ins = _ssd_inputs(card, 2, T, H, G, 64, 64, torch.bfloat16, seed=5,
                      ramp=ramp)
    k3.reset_launch_count()
    got = k3.ssd_scan_fwd(*ins, chunk=chunk)
    assert k3.launch_counts() == {"tensor_core": 1, "simt": 0}
    want = ssd_scan_plain(*(t.float() for t in ins))
    torch.testing.assert_close(got.float(), want, **_tol(torch.bfloat16))
    assert _errors(got, want)[1] <= ROW_REL_TOL


@pytest.mark.parametrize("T,H,G,N,chunk", [
    (1024, 32, 1, 64, 128),     # a reduced zamba2 prefill
    (256, 8, 1, 128, 128),      # mamba2-2.7b's state width
    (256, 8, 1, 128, 64),
    (256, 8, 2, 128, 128),
])
def test_k3_tensor_core_within_four_times_simt(card, T, H, G, N, chunk):
    """P 64 on the model's ramps: the tensor-core variant, every (token,
    head) row within 1e-2 of the float32 plain version of the same bf16
    inputs, and its max abs and worst row error at most 4 x those of the
    SIMT variant on those inputs (the same function at chunk 32, where
    bf16 goes SIMT)."""
    ins = _ssd_inputs(card, 1, T, H, G, 64, N, torch.bfloat16, seed=6,
                      ramp=True)
    want = ssd_scan_plain(*(t.float() for t in ins))
    k3.reset_launch_count()
    tc_abs, tc_row = _errors(k3.ssd_scan_fwd(*ins, chunk=chunk), want)
    assert k3.launch_counts() == {"tensor_core": 1, "simt": 0}
    simt_abs, simt_row = _errors(k3.ssd_scan_fwd(*ins, chunk=32), want)
    assert k3.launch_counts() == {"tensor_core": 1, "simt": 1}
    assert tc_row <= ROW_REL_TOL
    assert tc_abs <= 4 * simt_abs and tc_row <= 4 * simt_row, \
        (tc_abs, simt_abs, tc_row, simt_row)


@pytest.mark.parametrize("N", [64, 128])
def test_k3_tensor_core_reads_xbc_views(card, N):
    """x, B and C as column slices of the layer's xBC tensor (mamba2's
    layout at N 128): TMA reads the strides, no copy is made."""
    ins = _xbc_views(card, 512, 8, torch.bfloat16, N=N)
    assert not ins[0].is_contiguous()
    k3.reset_launch_count()
    got = k3.ssd_scan_fwd(*ins)
    assert k3.launch_counts() == {"tensor_core": 1, "simt": 0}
    want = ssd_scan_plain(*(t.float() for t in ins))
    assert _errors(got, want)[1] <= ROW_REL_TOL


@pytest.mark.parametrize("N", [64, 128])
def test_k3_misaligned_bf16_raises(card, N):
    """A bf16 call that TMA cannot read raises, at either state width of
    the tensor-core variant; it never goes to the SIMT variant."""
    x, dt, A, Bm, Cm = _ssd_inputs(card, 2, 128, 4, 1, 64, N,
                                   torch.bfloat16)
    buf = torch.zeros(x.numel() + 1, device=card, dtype=torch.bfloat16)
    shifted = buf[1:].view(x.shape)             # one element off 16 bytes
    assert k3.route(torch.bfloat16, 64, N, 128) == "tensor_core"
    k3.reset_launch_count()
    for bad in ((shifted, dt, A, Bm, Cm),
                _xbc_views(card, 128, 8, torch.bfloat16, pad=4, N=N)):
        with pytest.raises(ValueError, match="16 bytes"):
            k3.ssd_scan_fwd(*bad)
    assert k3.launch_count() == 0


@pytest.mark.parametrize("dtype,N", [
    (torch.float32, 128),       # mamba2-2.7b's state width in float32
    (torch.float32, 256),
    (torch.bfloat16, 256),      # bf16 N 128 takes the tensor cores
])
def test_k3_simt_wide_state_matches_plain(card, dtype, N):
    """P 64, chunk 128 (two chunks of T 256), H 8 on the model's ramps:
    the SIMT variant, which tiles N inside its block, against the float32
    plain version of the same inputs."""
    ins = _ssd_inputs(card, 1, 256, 8, 1, 64, N, dtype, seed=7, ramp=True)
    k3.reset_launch_count()
    got = k3.ssd_scan_fwd(*ins, chunk=128)
    assert k3.launch_counts() == {"tensor_core": 0, "simt": 1}
    want = ssd_scan_plain(*(t.float() for t in ins))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **_tol(dtype))
    else:
        assert _errors(got, want)[1] <= ROW_REL_TOL


@pytest.mark.parametrize("N", [64, 128])
def test_k3_tensor_core_reuses_ring_slots(card, N):
    """32 chunks per head (T 4096, H 4, G 1) on the ramps: each slot of
    the two-slot hand-off ring, a float32 (64, N) state, is written 16
    times; every row within 1e-2 of the float32 plain version."""
    ins = _ssd_inputs(card, 1, 4096, 4, 1, 64, N, torch.bfloat16, seed=8,
                      ramp=True)
    k3.reset_launch_count()
    got = k3.ssd_scan_fwd(*ins, chunk=128)
    assert k3.launch_counts() == {"tensor_core": 1, "simt": 0}
    want = ssd_scan_plain(*(t.float() for t in ins))
    torch.testing.assert_close(got.float(), want, **_tol(torch.bfloat16))
    assert _errors(got, want)[1] <= ROW_REL_TOL


def test_k3_simt_fits_every_supported_width(card):
    """The SIMT kernel tiles N (and P beyond 64) inside its block, so its
    shared memory, as the library reports it, fits one block for every
    chunk up to 128 with P in 16 .. 128 and N in 16 .. 256, multiples of 4
    — mamba2-2.7b's (128, 64, 128) among them, which needed 273,920 bytes
    when the block held all of N."""
    lib = k3._library()
    need = {(Q, P, N): lib.ssd_scan_smem_bytes(Q, P, N)
            for Q in range(4, k3.MAX_CHUNK + 1, 4)
            for P in range(16, 129, 4) for N in range(16, 257, 4)}
    assert max(need.values()) <= k3.MAX_SMEM_BYTES
    assert need[(128, 64, 128)] == 190_976
    assert max(need.values()) == need[(128, 128, 256)] == 225_792


def test_k3_float32_takes_simt(card):
    ins = _ssd_inputs(card, 1, 256, 4, 1, 64, 64, torch.float32)
    k3.reset_launch_count()
    k3.ssd_scan_fwd(*ins)
    assert k3.launch_counts() == {"tensor_core": 0, "simt": 1}


def test_prefill_on_card_matches_cpu(card):
    """Reduced zamba2 in float32: the card (through K2 and K3) against
    the CPU (through the plain versions) with one set of parameters;
    the kernels launch once per shared-block application and once per
    SSD layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM, build_model, prefill
    cfg = get_config("zamba2-7b").reduced(dtype="float32")
    on_card = build_model(cfg, seed=0)
    on_cpu = LM(cfg, torch.device("cpu"))
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    k2.reset_launch_count()
    k3.reset_launch_count()
    got = prefill(on_card, {"tokens": tok.to(card)})
    assert (k2.launch_count(), k3.launch_count()) == (2, 4)
    want = prefill(on_cpu, {"tokens": tok})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


def _select_rows_matches_plain(args, card, smem_limit=None):
    """K1's fused selection on the card equals its plain version there,
    bitwise, in one launch."""
    args = to_device(args, card)
    before = select_move.launch_counts()["select_rows"]
    got = select_move.select_rows_fwd(*args, smem_limit=smem_limit)
    assert select_move.launch_counts()["select_rows"] == before + 1
    want = select_rows_ref(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("any", "dst", "cand_src"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("case", CARRIES, ids=carry_id)
def test_k1_select_rows_matches_plain(card, case):
    _select_rows_matches_plain(carry(*case), card)


@pytest.mark.parametrize("inside", [False, True], ids=["on", "inside"])
@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_d"])
def test_k1_select_rows_on_a_knife_edge(card, cluster, inside):
    args, _ = knife_edge(carry(cluster, 0, True, False), inside)
    _select_rows_matches_plain(args, card)


def test_k1_select_rows_without_staging(card):
    """Device vectors that do not fit a block's shared memory are read
    from device memory, with the same results."""
    for case in CARRIES[::4]:
        _select_rows_matches_plain(carry(*case), card, smem_limit=0)


def test_k1_select_rows_rebinds_a_replaced_carry(card):
    """A carry bound once follows a tensor of it that the planner
    replaces (a re-pad widens ``rows_on``): the next call checks and
    packs the carry again and still equals the plain version."""
    src_order, n_avail, cap_lim, dyn, const, scal = to_device(
        carry("cluster_a", 0, True, False), card)
    bound = select_move.SelectRows(cap_lim, dyn, const, scal)
    pad = torch.full((dyn["rows_on"].shape[0], 8), -1,
                     dtype=dyn["rows_on"].dtype, device=card)
    dyn["rows_on"] = torch.cat([dyn["rows_on"], pad], dim=1)
    got = bound(src_order, n_avail)
    want = select_rows_ref(src_order, n_avail, cap_lim, dyn, const, scal)
    torch.cuda.synchronize()
    assert got[0].shape == want[0].shape
    for name, g, w in zip(("any", "dst", "cand_src"), got, want):
        assert torch.equal(g, w), name


def test_k1_select_rows_raises(card):
    """A call the kernel cannot take raises and launches nothing."""
    src_order, n_avail, cap_lim, dyn, const, scal = to_device(
        carry("small_test_cluster", 0, True, False), card)
    bad = {"util float32": ({**dyn, "util": dyn["util"].float()}, const),
           "dev_in on the CPU": (dyn, {**const,
                                       "dev_in": const["dev_in"].cpu()}),
           "strided used": ({**dyn, "used": dyn["used"].repeat(2)[::2]},
                            const)}
    before = select_move.launch_count()
    for name, (d, c) in bad.items():
        with pytest.raises(ValueError):
            select_move.select_rows_fwd(src_order, n_avail, cap_lim, d, c,
                                        scal)
    assert select_move.launch_count() == before
