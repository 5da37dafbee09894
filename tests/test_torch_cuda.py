"""The port's CUDA kernels K1's fused selection (``select_rows``), K2
(flash attention) and K3 (the SSD scan) against their plain versions,
and the LM prefill through them against the same parameters on the CPU;
the decode step and the serving engine on the card against the CPU;
K2's log-sum-exp in both variants, the training backward through K2 and
K3 against the all-plain one on the card, and a train step on the card
against the CPU.  Every test needs a card (``cuda``
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
edge of the variance test on each side among them, and so is its cached
instantiation (the batch engine's legality cache) in each cache state,
the engine's own cache included, with ``cand_row`` and the cache it
writes; a malformed cache raises.  The batch engine with the cache on,
pipelined or not, gives the CPU run's moves and counters under a tracer.
The batch engine's
warm continuation after each delta type equals a cold plan on the card,
with ``select_rows`` launched once a step.  K1's lane launch (the fleet's
one launch a bucket step) equals the lane form of its plain version,
staged and from device memory, a one-lane launch the launch without the
lane axis, and a cached launch of stacked lanes raises; the fleet on the
card equals serial planners on the card lane by lane.  The dense legacy lane on the
card equals the faithful planner, with the standalone ``masked_select``
launched once per evaluated source.  K1's window form (the sharded
engine's) equals ``select_rows_window_ref`` bitwise on 2- and 4-way
windows of the carries, staged and from device memory, and the sharded
engine in an NCCL group of one rank equals the serial engine on the card
on the small paper clusters."""

import numpy as np
import pytest
import torch

from _select_rows_carries import (CARRIES, cache_states, carry, carry_id,
                                  engine_cache, knife_edge, to_device)
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


def test_decode_step_on_card_matches_cpu(card):
    """Reduced zamba2 in float32, 8 decode steps from an empty cache on
    the card and on the CPU with one set of parameters: every step's
    logits and the final cache within 1e-4; no kernel launches (decode
    attention takes the direct product, SSD the one-token recurrence)."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM, build_model, decode_step, init_cache
    cfg = get_config("zamba2-7b").reduced(dtype="float32")
    on_card = build_model(cfg, seed=0)
    on_cpu = LM(cfg, torch.device("cpu"))
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    card_cache = init_cache(cfg, 2, 16, card)
    cpu_cache = init_cache(cfg, 2, 16, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 2, 1)))
    k2.reset_launch_count()
    k3.reset_launch_count()
    for step in tokens:
        got, card_cache = decode_step(on_card, card_cache, step.to(card))
        want, cpu_cache = decode_step(on_cpu, cpu_cache, step)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert (k2.launch_count(), k3.launch_count()) == (0, 0)
    assert card_cache["len"] == cpu_cache["len"] == 8
    for leaf in ("ssd", "conv", "k", "v"):
        torch.testing.assert_close(card_cache[leaf].cpu(), cpu_cache[leaf],
                                   rtol=1e-4, atol=1e-4)


def test_serve_engine_on_card_generates_the_cpu_tokens(card):
    """A 2-slot engine over reduced qwen3 in float32 on the card and on
    the CPU, the same three requests: the same tokens, steps and
    migrated bytes."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM, build_model
    from repro_torch.serve import PagedKVPool, PagedKVSpec, Request, \
        ServeEngine
    cfg = get_config("qwen3-0.6b").reduced(n_layers=2, vocab_size=64,
                                           dtype="float32")
    on_card = build_model(cfg, seed=0)
    on_cpu = LM(cfg, torch.device("cpu"))
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    runs = []
    for model in (on_card, on_cpu):
        engine = ServeEngine(cfg, model, batch_slots=2, max_len=64,
                             pool=PagedKVPool(PagedKVSpec(
                                 n_chips=2, page_tokens=8,
                                 pages_per_chip=64)))
        reqs = [Request(id=i, prompt=np.array([1 + i, 2, 3]),
                        max_new_tokens=4 + i) for i in range(3)]
        for r in reqs:
            engine.submit(r)
        engine.run(max_steps=200)
        assert not (engine.active or engine.queue)
        runs.append(([r.generated for r in reqs], engine.steps,
                     engine.migrated_bytes))
    assert runs[0] == runs[1]
    assert [len(g) for g in runs[0][0]] == [4, 5, 6]


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


def _cached_matches_plain(args, cache, card, smem_limit=None):
    """K1's cached instantiation on the card equals the plain version with
    the same cache, bitwise: the outputs, ``cand_row`` and the cache each
    writes; one launch, counted as cached."""
    args = to_device(args, card)
    cache = {k: v.to(card) if isinstance(v, torch.Tensor) else v
             for k, v in cache.items()}
    out_k, out_p = cache["cache_ok"].clone(), cache["cache_ok"].clone()
    before = select_move.launch_counts()["select_rows"]
    cached = select_move.cached_launch_count()
    got = select_move.select_rows_fwd(*args, smem_limit=smem_limit, **cache,
                                      cache_out=out_k, cand_row=True)
    assert select_move.launch_counts()["select_rows"] == before + 1
    assert select_move.cached_launch_count() == cached + 1
    want = select_rows_ref(*args, **cache, cache_out=out_p, cand_row=True)
    torch.cuda.synchronize()
    for name, g, w in zip(("any", "dst", "cand_src", "cand_row"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert torch.equal(out_k, out_p), "the written cache"
    return got


@pytest.mark.parametrize("case", CARRIES, ids=carry_id)
def test_k1_cached_select_rows_matches_plain(card, case):
    """Each cache state (every block a miss, every block a hit, a tag
    mismatch) on each test carry, staged and, for every fourth carry,
    from device memory."""
    args = carry(*case)
    limits = (None, 0) if CARRIES.index(case) % 4 == 0 else (None,)
    for _name, cache, _fresh in cache_states(args):
        for limit in limits:
            _cached_matches_plain(args, cache, card, limit)


@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_a"])
def test_k1_cached_select_rows_on_the_engines_cache(card, cluster):
    """The engine's own cache after planning steps with it: the kernel
    equals the plain version, and the uncached selection."""
    args, cache = engine_cache(cluster, 40)
    got = _cached_matches_plain(args, cache, card)
    plain = select_rows_ref(*to_device(args, card))
    for g, w in zip(got[:3], plain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cluster", ["small_test_cluster", "sim_cluster"])
def test_k1_select_rows_at_a_padded_source_block(card, cluster):
    """The batch engine's input at source_block 3: k_pad positions with
    device 0 in the padding and each tile's hit spread over its slots.
    The uncached kernel, and the cached one on the engine's own cache
    (staged and from device memory) and in each cache state, bitwise
    the plain version's."""
    args, cache = engine_cache(cluster, 60, source_block=3)
    dev_args = to_device(args, card)
    got = select_move.select_rows_fwd(*dev_args, cand_row=True)
    want = select_rows_ref(*dev_args, cand_row=True)
    torch.cuda.synchronize()
    for name, g, w in zip(("any", "dst", "cand_src", "cand_row"), got, want):
        assert torch.equal(g, w), name
    for limit in (None, 0):
        _cached_matches_plain(args, cache, card, limit)
    for _name, state, _fresh in cache_states(args):
        _cached_matches_plain(args, state, card)


def test_k1_cached_select_rows_reads_the_cache(card):
    """A legal pair cleared from a clean block of the engine's cache
    leaves the kernel's selection, as it leaves the plain version's."""
    args, cache = engine_cache("cluster_a", 60, legal_hit=True)
    plain = select_rows_ref(*args)
    k, R = cache["hit_blk"].shape[0], args[3]["rows_on"].shape[1]
    hit_rows = cache["hit_blk"].repeat_interleave(cache["rb"], 1)
    q, r = (int(i) for i in (plain[0].view(k, R) & hit_rows).nonzero()[0])
    cache["cache_ok"][q, r, int(plain[1].view(k, R)[q, r])] = False
    got = _cached_matches_plain(args, cache, card)
    assert not torch.equal(got[0].cpu(), plain[0])


def test_k1_cached_select_rows_raises(card):
    """A malformed cache raises and launches nothing: never the uncached
    kernel or the plain version in its place."""
    args = to_device(carry("small_test_cluster", 0, True, False), card)
    k, R = args[0].shape[0], args[3]["rows_on"].shape[1]
    n = args[3]["used"].shape[0]
    ok = torch.zeros((k, R, n), dtype=torch.bool, device=card)
    hit = torch.zeros((k, R // 8), dtype=torch.bool, device=card)
    bad = {"uint8 cache": dict(cache_ok=ok.to(torch.uint8), hit_blk=hit,
                               rb=8),
           "short cache": dict(cache_ok=ok[:, :R - 8], hit_blk=hit, rb=8),
           "hit_blk on the CPU": dict(cache_ok=ok, hit_blk=hit.cpu(), rb=8),
           "strided cache_out": dict(cache_ok=ok, hit_blk=hit, rb=8,
                                     cache_out=ok.transpose(0, 1)),
           "row block not dividing R": dict(cache_ok=ok, hit_blk=hit,
                                            rb=R + 1),
           "hit_blk without a cache": dict(hit_blk=hit)}
    before = select_move.launch_count()
    for name, cache in bad.items():
        with pytest.raises(ValueError):
            select_move.select_rows_fwd(*args, **cache)
    assert select_move.launch_count() == before


def _counted(planner, state):
    """One traced plan to convergence: its moves, certificate counters
    and the opt-ins' registry deltas."""
    from repro_torch import obs
    reg = obs.registry()
    with obs.tracing():
        snap = reg.snapshot()
        res = planner.plan(state, record_trajectory=True)
        d = reg.deltas_since(snap)
    keys = ("tiles_walked", "cand_tiles", "cache_hits", "cache_misses",
            "cache_repairs", "chunks_overlapped", "repads", "stash_moves")
    return {"moves": [(m.pg, m.slot, m.src_osd, m.dst_osd)
                      for m in res.moves],
            "tried": [r.sources_tried for r in res.records],
            "bound_hits": res.stats["bound_hits"],
            "pruned": res.stats["pruned_sources"],
            **{key: int(d.get(f"batch.{key}", 0)) for key in keys},
            "chunks": int(d.get("batch.chunks", 0))}


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipe", "nopipe"])
@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_a"])
def test_batch_optins_on_card_match_cpu(card, cluster, pipeline):
    """``equilibrium_batch`` with the legality cache on the card, pipelined
    or not, under a tracer: the CPU run's moves, ``sources_tried``,
    certificate counters and opt-in counters; ``select_rows`` once a
    step, every launch the cached instantiation."""
    from repro_torch.core import clustergen
    from repro_torch.core.planner import create_planner
    runs = {}
    for device in ("cpu", "cuda"):
        select_move.reset_launch_count()
        planner = create_planner("equilibrium_batch", chunk=8,
                                 legality_cache=True, pipeline=pipeline,
                                 device=device)
        runs[device] = _counted(planner, getattr(clustergen, cluster)())
        launches = select_move.launch_counts()
    assert runs["cuda"] == runs["cpu"]
    assert runs["cuda"]["cache_hits"] > 0
    assert launches == {"select_rows": 8 * runs["cuda"]["chunks"],
                        "masked_select": 0, "select_rows_window": 0}
    assert select_move.cached_launch_count() == launches["select_rows"]


# ---------------------------------------------------------------------------
# the batch engine's warm start on the card


def _warm_mutate(name: str, state) -> None:
    """One delta of each type on the port's small paper cluster (no JAX
    here: the reference lanes are held in ``tests/test_torch_warm.py``)."""
    from repro_torch.core import (Device, Movement, PlacementRule, Pool,
                                  TiB, place_pg)
    from repro_torch.core.equilibrium import EquilibriumConfig
    from repro_torch.core.planner import create_planner
    if name == "growth":
        state.grow_pool(0, 2.0 * TiB)
    elif name == "device-add":
        state.add_device(Device(id=500, capacity=8 * TiB,
                                device_class="hdd", host="hx"))
    elif name == "renumbering-class":
        state.add_device(Device(id=502, capacity=4 * TiB,
                                device_class="aaa-first", host="ha"))
    elif name == "device-out":
        state.mark_out(state.devices[1].id)
    elif name == "foreign-movement":
        mv = create_planner("equilibrium_faithful",
                            cfg=EquilibriumConfig(max_moves=1)).plan(
            _exact_copy(state)).moves[0]
        state.apply(Movement(mv.pg, mv.slot, mv.src_osd, mv.dst_osd,
                             mv.size))
    elif name == "pool-create":
        pid = 1 + max(state.pools)
        pool = Pool(pid, "fresh", 8, PlacementRule.replicated(2, "host",
                                                             "hdd"),
                    stored_bytes=0.4 * TiB)
        state.add_pool(pool, {(pid, i): place_pg(state.devices, pool, i,
                                                 seed=3) for i in range(8)},
                       {(pid, i): pool.nominal_shard_size for i in range(8)})


def _exact_copy(state):
    from repro_torch.core import ClusterState
    return ClusterState.from_plain(state.to_plain())


@pytest.mark.parametrize("first_budget", [5, 3], ids=["synced", "stash"])
@pytest.mark.parametrize("name", ["growth", "device-add", "device-out",
                                  "foreign-movement", "pool-create",
                                  "renumbering-class"])
def test_warm_continuation_on_card_matches_cold(card, name, first_budget):
    """After each delta type the warm continuation on the card equals a
    cold plan on the card of the mutated state, move for move and in
    ``sources_tried``; it absorbs (no rebuild) except where a new class
    renumbers the carry's ids, and K1's ``select_rows`` runs once a step
    on the refreshed carry."""
    from repro_torch import obs
    from repro_torch.core.clustergen import small_test_cluster
    from repro_torch.core.planner import create_planner
    state = small_test_cluster()
    planner = create_planner("equilibrium_batch", chunk=5, device="cuda")
    planner.plan(state, budget=first_budget)
    _warm_mutate(name, state)
    cold = create_planner("equilibrium_batch", chunk=5, device="cuda").plan(
        _exact_copy(state), record_trajectory=True)
    reg = obs.registry()
    snap = reg.snapshot()
    select_move.reset_launch_count()
    warm = planner.plan(state, record_trajectory=True)
    launches = select_move.launch_counts()
    d = reg.deltas_since(snap)
    assert [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in warm.moves] \
        == [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in cold.moves]
    assert [r.sources_tried for r in warm.records] \
        == [r.sources_tried for r in cold.records]
    assert warm.stats["rebuilds"] == (name == "renumbering-class")
    assert d.get("absorb.runs", 0) == (name != "renumbering-class")
    assert launches == {"select_rows": 5 * int(d.get("batch.chunks", 0)),
                        "masked_select": 0, "select_rows_window": 0}
    state.check_valid()


@pytest.mark.parametrize("slack", [False, True], ids=["default", "slack"])
@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_a",
                                     "cluster_c"])
def test_legacy_lane_on_card_matches_faithful(card, cluster, slack):
    """The dense legacy lane on the card (its default device) emits the
    faithful planner's sequence, move for move and in ``sources_tried``,
    at the default config and the slack regression's; it launches K1's
    standalone reduction once per evaluated source (one fetch each) and
    the fused ``select_rows`` never."""
    from repro_torch.core import clustergen
    from repro_torch.core.equilibrium import EquilibriumConfig
    from repro_torch.core.planner import create_planner
    kw = dict(count_slack=1.39, min_variance_delta=1e-5) if slack else {}
    cfg = EquilibriumConfig(max_moves=120, **kw)
    base = getattr(clustergen, cluster)()
    ref = create_planner("equilibrium_faithful", cfg=cfg).plan(
        _exact_copy(base), record_trajectory=True)
    planner = create_planner("equilibrium_jax_legacy", cfg=cfg)
    assert planner.device.type == "cuda"
    select_move.reset_launch_count()
    got = planner.plan(_exact_copy(base), record_trajectory=True)
    launches = select_move.launch_counts()
    assert len(got.moves) > 0
    assert [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in got.moves] \
        == [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in ref.moves]
    assert [r.sources_tried for r in got.records] \
        == [r.sources_tried for r in ref.records]
    n = got.stats["host_syncs"]
    assert n >= len(got.moves)
    assert launches == {"select_rows": 0, "masked_select": n,
                        "select_rows_window": 0}


def test_fuzz_timeline_on_card_passes_every_oracle(card):
    """One generated timeline through the port's whole ``"equilibrium"``
    class with the device left at its default, the card: the batch lane's
    ``select_rows`` once a step, the sharded lane's window form once a
    step and the legacy lane's ``masked_select`` once per evaluated
    source, every oracle passing (legality, variance, conservation,
    agreement, at most one rebuild, the baselines and the replay)."""
    from repro_torch import fuzz
    from repro_torch.sim import generate_timeline
    select_move.reset_launch_count()
    lanes = fuzz.run_timeline(generate_timeline(0))
    launches = select_move.launch_counts()
    assert set(lanes) == {"equilibrium", "equilibrium_batch",
                          "equilibrium_batch_sharded",
                          "equilibrium_faithful", "equilibrium_jax_legacy",
                          "fleet", "mgr", "none"}
    assert lanes["equilibrium"].planned_moves > 0
    assert lanes["equilibrium_batch"].rebuilds == 1
    assert lanes["equilibrium_batch_sharded"].rebuilds == 1
    assert launches["select_rows"] > 0 and launches["masked_select"] > 0
    assert launches["select_rows_window"] > 0


def test_fuzz_slack_regression_through_the_card_legacy_lane(card):
    """``tests/regressions/legacy-slack-divergence.json`` (the float32
    downcast that once diverged the legacy lane) through the port class on
    the card, the legacy lane included, under every oracle."""
    from repro_torch import fuzz
    tl = fuzz.load_timeline(fuzz.corpus_dir()
                            / "legacy-slack-divergence.json")
    select_move.reset_launch_count()
    lanes = fuzz.run_timeline(tl, engines=(
        "equilibrium", "equilibrium_faithful", "equilibrium_batch",
        "equilibrium_jax_legacy"))
    launches = select_move.launch_counts()
    assert lanes["equilibrium_jax_legacy"].planned_moves == 30
    assert launches["masked_select"] > 0 and launches["select_rows"] > 0


def test_fuzz_mutation_does_not_reach_the_card_kernel(card):
    """``select_rows`` compiles the class fence into the kernel: under the
    ``class_blind`` mutation the batch lane on the card still plans the
    healthy moves (which is why the CLI refuses that combination), while
    the host lane plans the illegal one the oracle catches."""
    from repro_torch import fuzz
    tl = fuzz.load_timeline(fuzz.corpus_dir() / "class-fence-mutant.json")
    healthy = fuzz.run_lane(tl, "equilibrium")
    with fuzz.mutated("class_blind"):
        on_card = fuzz.run_lane(tl, "equilibrium_batch")
        with pytest.raises(fuzz.OracleFailure, match="illegal move"):
            fuzz.run_lane(tl, "equilibrium")
    assert on_card.moves == healthy.moves
    assert on_card.metrics_json == healthy.metrics_json


# ---------------------------------------------------------------------------
# K1 with a lane axis: the fleet's one launch a bucket


def _card_bucket(card, sizes=((9, 0), (12, 1), (16, 2))):
    """A fleet on the card of lanes of distinct sizes in one bucket (the
    9- and 12-device lanes padded to 16, their ``k_eff`` below the
    bucket's k), planned one tick, and the bucket's step."""
    from repro_torch.core.clustergen import sim_cluster
    from repro_torch.fleet import FleetPlanner
    fp = FleetPlanner(chunk=8, row_block=8, device=card)
    for j, (n, seed) in enumerate(sizes):
        fp.add_cluster(f"c{j}", sim_cluster(seed=seed, n_hdd=n, n_ssd=0,
                                            fill=0.6))
    fp.plan_fleet({f"c{j}": 8 for j in range(len(sizes))})
    (bucket,) = fp._pack.buckets.values()
    return fp, bucket, fp._step_of(bucket)


@pytest.mark.parametrize("smem_limit", [None, 0], ids=["staged", "device"])
def test_k1_lane_launch_matches_plain_lane_form(card, smem_limit):
    """One launch for three stacked lanes (padded devices, per-lane
    ``n_f`` and ``k_eff``) equals the lane form of the plain version on
    the same inputs, bitwise, staged and from device memory."""
    from repro_torch.kernels.ref import select_rows_lanes_ref
    _, bucket, step = _card_bucket(card)
    _, src_order, n_avail = step.sources()
    bound = select_move.SelectRows(step.cap_lim, step.dyn, step.const,
                                   step.scal, smem_limit=smem_limit,
                                   lanes=True)
    before = select_move.launch_counts()["select_rows"]
    got = bound(src_order, n_avail, cand_row=True)
    assert select_move.launch_counts()["select_rows"] == before + 1
    want = select_rows_lanes_ref(src_order, n_avail, step.cap_lim, step.dyn,
                                 step.const, step.scal, cand_row=True)
    torch.cuda.synchronize()
    assert got[0].shape == (3, bucket.shape.k * step.r_cap)
    for name, g, w in zip(("any", "dst", "cand_src", "cand_row"), got,
                          want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def test_k1_one_lane_launch_is_the_single_launch(card):
    """A carry stacked as one lane gives the launch without the lane
    axis, bitwise."""
    src_order, n_avail, cap_lim, dyn, const, scal = to_device(
        carry("cluster_a", 0, True, False), card)
    one = select_move.SelectRows(
        cap_lim[None], {k: v[None] for k, v in dyn.items()},
        {k: v[None] for k, v in const.items()},
        {k: v.reshape(1) for k, v in scal.items()}, lanes=True)
    got = one(src_order[None], n_avail.reshape(1), cand_row=True)
    want = select_move.select_rows_fwd(src_order, n_avail, cap_lim, dyn,
                                       const, scal, cand_row=True)
    torch.cuda.synchronize()
    for name, g, w in zip(("any", "dst", "cand_src", "cand_row"), got,
                          want):
        assert torch.equal(g[0], w), name


def test_k1_cached_launch_refuses_lanes(card):
    """The cached instantiation takes one carry: the wrapper refuses a
    cache on stacked lanes, and the C entry refuses a cached launch of
    more than one lane with an error the wrapper raises on; neither
    launches anything."""
    _, bucket, step = _card_bucket(card)
    _, src_order, n_avail = step.sources()
    k, R, n = src_order.shape[1], step.r_cap, step.dyn["used"].shape[1]
    ok = torch.zeros((k, R, n), dtype=torch.bool, device=card)
    hit = torch.zeros((k, R // 8), dtype=torch.bool, device=card)
    before = select_move.launch_count()
    with pytest.raises(ValueError, match="cache"):
        step.select_rows(src_order, n_avail, cache_ok=ok, hit_blk=hit, rb=8)
    args = to_device(carry("small_test_cluster", 0, True, False), card)
    k1, R1, n1 = (args[0].shape[0], args[3]["rows_on"].shape[1],
                  args[3]["used"].shape[0])
    bound = select_move.SelectRows(*args[2:])
    bound._args.lanes = 2            # as a stacked carry would claim
    with pytest.raises(RuntimeError, match="CUDA error"):
        bound(*args[:2],
              cache_ok=torch.zeros((k1, R1, n1), dtype=torch.bool,
                                   device=card),
              hit_blk=torch.zeros((k1, R1 // 8), dtype=torch.bool,
                                  device=card), rb=8)
    assert select_move.launch_count() == before


def test_fleet_on_card_matches_serial_on_card(card):
    """Three lanes of different sizes on the card to convergence: each
    lane's moves and certificate counters equal a serial ``BatchPlanner``
    configured like a fleet lane on the card, one ``select_rows`` launch
    a bucket step, one host sync a round, and no host sync inside a fleet
    chunk."""
    from repro_torch import obs
    from repro_torch.core.clustergen import sim_cluster
    from repro_torch.core.planner import create_planner
    from repro_torch.fleet import FleetPlanner
    sizes = ((9, 0), (12, 1), (18, 2))
    fp = FleetPlanner(chunk=8, row_block=8, device=card)
    states, twins, serial = {}, {}, {}
    for j, (n, seed) in enumerate(sizes):
        states[j] = sim_cluster(seed=seed, n_hdd=n, n_ssd=0, fill=0.6)
        twins[j] = sim_cluster(seed=seed, n_hdd=n, n_ssd=0, fill=0.6)
        fp.add_cluster(j, states[j])
        serial[j] = create_planner("equilibrium_batch", chunk=8,
                                   row_block=8, device=card)
    reg = obs.registry()
    snap = reg.snapshot()
    select_move.reset_launch_count()
    keys = ("bound_hits", "pruned_sources", "tail_moves",
            "sources_tried_hist")
    for _ in range(40):
        res = fp.plan_fleet({j: 8 for j in states})
        for j in states:
            want = serial[j].plan(twins[j], budget=8)
            assert [(m.pg, m.slot, m.src_osd, m.dst_osd)
                    for m in res[j].moves] == \
                [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in want.moves]
            assert {k: res[j].stats[k] for k in keys} == \
                {k: want.stats[k] for k in keys}
        if all(r.stats["converged"] for r in res.values()):
            break
    d = reg.deltas_since(snap)
    fleet_steps = int(d["fleet.chunks"]) * 8
    serial_steps = int(d["batch.chunks"]) * 8
    assert select_move.launch_counts()["select_rows"] \
        == fleet_steps + serial_steps
    assert int(d["fleet.round_syncs"]) == int(d["fleet.rounds"]) > 0
    bucket = next(iter(fp._pack.buckets.values()))
    step = fp._step_of(bucket)
    mask = torch.ones(len(bucket), dtype=torch.bool, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step.run(8, mask)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------------------
# K1's window form and the sharded engine


@pytest.mark.parametrize("smem_limit", [None, 0], ids=["staged", "device"])
@pytest.mark.parametrize("ways", [2, 4])
def test_k1_window_matches_plain(card, ways, smem_limit):
    """K1's window form on the card equals ``select_rows_window_ref``
    bitwise (any, global dst, cand_src, cand_row), staged and from device
    memory, on every window of every carry: one launch a window."""
    from _select_rows_carries import window_args
    from repro_torch.kernels.ref import select_rows_window_ref
    for case in CARRIES:
        args = carry(*case)
        for rank in range(ways):
            wargs, base = window_args(args, ways, rank)
            wargs = to_device(wargs, card)
            bound = select_move.SelectRowsWindow(*wargs[6:], base,
                                                 smem_limit=smem_limit)
            before = select_move.launch_counts()["select_rows_window"]
            got = bound(*wargs[:6], cand_row=True)
            assert select_move.launch_counts()["select_rows_window"] \
                == before + 1
            want = select_rows_window_ref(*wargs, base=base, cand_row=True)
            torch.cuda.synchronize()
            for name, g, w in zip(("any", "dst", "cand_src", "cand_row"),
                                  got, want):
                assert g.dtype == w.dtype and torch.equal(g, w), \
                    (carry_id(case), rank, name)


def test_k1_window_raises(card):
    """A window the kernel cannot take raises and launches nothing."""
    from _select_rows_carries import window_args
    wargs, base = window_args(carry("cluster_a", 0, True, False), 2, 1)
    wargs = to_device(wargs, card)
    before = select_move.launch_count()
    with pytest.raises(ValueError, match="window"):
        select_move.SelectRowsWindow(*wargs[6:], base + 1)
    bound = select_move.SelectRowsWindow(*wargs[6:], base)
    with pytest.raises(ValueError, match="bad shapes"):
        bound(*wargs[:3], wargs[3][..., :7].contiguous(), *wargs[4:6])
    with pytest.raises(ValueError, match="CUDA device"):
        bound(wargs[0].cpu(), *wargs[1:6])
    assert select_move.launch_count() == before


@pytest.mark.parametrize("cluster", ["small_test_cluster", "cluster_a",
                                     "cluster_d"])
def test_sharded_engine_nccl_group_of_one_matches_serial(card, cluster):
    """The sharded engine on the card in an NCCL group of one rank equals
    the serial engine on the card (moves, sources tried, certificate
    counters), with one window launch a step and no unwindowed
    ``select_rows``, and a sharded chunk syncs nothing."""
    import tempfile

    import torch.distributed as dist
    from repro_torch import obs
    from repro_torch.core import clustergen
    from repro_torch.core.planner import create_planner
    from repro_torch.core.shard import ShardedBatchPlanner
    keys = ("bound_hits", "pruned_sources", "sources_tried_hist")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            want = create_planner("equilibrium_batch", chunk=8,
                                  device=card).plan(
                getattr(clustergen, cluster)(), record_trajectory=True)
            select_move.reset_launch_count()
            reg = obs.registry()
            snap = reg.snapshot()
            planner = create_planner("equilibrium_batch_sharded", chunk=8,
                                     device=card)
            got = planner.plan(getattr(clustergen, cluster)(),
                               record_trajectory=True)
            launches = select_move.launch_counts()
            steps = 8 * int(reg.deltas_since(snap)["batch.chunks"])
            bp = ShardedBatchPlanner(getattr(clustergen, cluster)(),
                                     chunk=8, device=card)
            bp.sync()
            bp._step.run(8)                  # the collectives' first calls
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                bp._step.run(8)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        finally:
            dist.destroy_process_group()
    assert [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in got.moves] \
        == [(m.pg, m.slot, m.src_osd, m.dst_osd) for m in want.moves]
    assert [r.sources_tried for r in got.records] \
        == [r.sources_tried for r in want.records]
    assert {k: got.stats[k] for k in keys} == {k: want.stats[k] for k in keys}
    assert got.stats["shards"] == 1
    assert got.stats["host_syncs"] == steps // 8     # one sync a chunk
    assert launches == {"select_rows": 0, "masked_select": 0,
                        "select_rows_window": steps}


# ---------------------------------------------------------------------------
# training: K2's log-sum-exp, the backward passes, a train step


@pytest.mark.parametrize("T,H,KV,Dh,window,cap,dtype", [
    (256, 4, 2, 128, None, None, torch.bfloat16),      # qwen3's heads
    (200, 4, 4, 112, 48, 30.0, torch.bfloat16),        # zamba2's, capped
    (256, 4, 2, 160, 70, None, torch.bfloat16),        # SIMT (Dh 160)
    (200, 4, 2, 64, None, 20.0, torch.float32),        # SIMT
])
def test_k2_lse_matches_plain(card, T, H, KV, Dh, window, cap, dtype):
    """K2 with ``with_lse``: the output as without it, and the rows'
    natural log-sum-exp (B, H, Tq) against the plain online version's on
    float32 copies of the same inputs, within 1e-4 in float32 and 2e-3
    in bf16 (values near log T; the tensor-core variant keeps its logits
    in log2 units, and a slip there would be off by about m (1 - ln 2))."""
    from repro_torch.kernels.ref import flash_attention_online
    g = torch.Generator(device=card).manual_seed(4)
    q, k, v = (torch.randn((2, T, h, Dh), generator=g, device=card).to(dtype)
               for h in (H, KV, KV))
    kw = dict(causal=True, window=window, cap=cap)
    variant = k2.route(dtype, Dh)
    k2.reset_launch_count()
    out, lse = k2.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    assert k2.launch_counts()[variant] == 1
    assert lse.shape == (2, H, T) and lse.dtype == torch.float32
    torch.testing.assert_close(out, k2.flash_attention_fwd(q, k, v, **kw),
                               rtol=0, atol=0)
    _, want = flash_attention_online(q.float(), k.float(), v.float(),
                                     with_lse=True, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(lse, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_grads_on_card_match_all_plain(card, dtype):
    """``ops.flash_attention`` on inputs that require a gradient (K2's
    forward with its lse, the plain backward) against the all-plain path
    on the card (the online forward's float32 ``out`` and lse, the same
    backward), at qwen3's heads (H 4 over KV 2, Dh 128) with a window.
    float32 within 1e-4; bf16 within 2e-2 of each gradient's largest
    entry: the gradients are bf16, and K2's ``out`` is bf16 where the
    plain forward's is float32, which ``delta = Σ dout·out`` carries."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (flash_attention_bwd_plain,
                                         flash_attention_online)
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn((2, 256, h, 128), generator=g, device=card)
               .to(dtype).requires_grad_() for h in (4, 2, 2))
    dout = torch.randn((2, 256, 4, 128), generator=g, device=card).to(dtype)
    kw = dict(causal=True, window=100, cap=None, scale=None)
    k2.reset_launch_count()
    out = ops.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert k2.launch_count() == 1
    out32, lse = flash_attention_online(q.detach(), k.detach(), v.detach(),
                                        with_lse=True, **kw)
    want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                     out32, lse, dout, **kw)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        tol = 1e-4 if dtype == torch.float32 \
            else 2e-2 * float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


def test_ssd_scan_grads_on_card_match_all_plain(card):
    """``ops.ssd_scan`` on bf16 inputs that require a gradient at
    mamba2's widths (P 64, N 128, chunk 64: the tensor-core K3) on the
    model's ramps: the forward within the bf16 row bound of the float32
    plain version, and the gradients equal to the all-plain ones (the
    backward recomputes the plain chunk loop from the saved inputs)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_chunked
    x, dt, A, Bm, Cm = _ssd_inputs(card, 1, 256, 4, 1, 64, 128,
                                   torch.bfloat16, seed=6, ramp=True)
    ins = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    dy = torch.randn_like(x)
    k3.reset_launch_count()
    y = ops.ssd_scan(*ins, chunk=64)
    got = torch.autograd.grad(y, ins, dy)
    assert k3.launch_counts() == {"tensor_core": 1, "simt": 0}
    plain = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y_plain = ssd_chunked(*plain, 64)[0]
    want = torch.autograd.grad(y_plain, plain, dy)
    torch.testing.assert_close(y.float(), y_plain.float(),
                               **_tol(torch.bfloat16))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_step_on_card_matches_cpu(card):
    """Reduced qwen3 and mamba2 in float32, one ``make_train_step`` step
    on the card (K2 SIMT, K3 SIMT forwards) and on the CPU from one set
    of parameters: the loss, the grad norm and every parameter after the
    update within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM, build_model
    from repro_torch.train import init_train_state, make_train_step
    for arch, want_launches in (("qwen3-0.6b", (2, 0)),
                                ("mamba2-2.7b", (0, 2))):
        cfg = get_config(arch).reduced(dtype="float32")
        on_card = build_model(cfg, seed=0)
        on_cpu = LM(cfg, torch.device("cpu"))
        on_cpu.load_state_dict({k: v.cpu() for k, v in
                                on_card.state_dict().items()})
        tok = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 64)))
        batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
        step = make_train_step(cfg)
        k2.reset_launch_count()
        k3.reset_launch_count()
        card_state, got = step(init_train_state(cfg, model=on_card),
                               {k: v.to(card) for k, v in batch.items()})
        # the forward and the full-remat recompute, per layer
        assert (k2.launch_count(), k3.launch_count()) == tuple(
            2 * n for n in want_launches)
        cpu_state, want = step(init_train_state(cfg, model=on_cpu), batch)
        for key in ("loss", "grad_norm", "lr"):
            torch.testing.assert_close(got[key].cpu(), want[key],
                                       rtol=1e-4, atol=1e-4)
        for (name, a), b in zip(card_state["params"].named_parameters(),
                                cpu_state["params"].parameters()):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4,
                                       msg=name)
