"""The port's CUDA kernels K2 (flash attention) and K3 (the SSD scan)
against their plain versions, and the LM prefill through them against
the same parameters on the CPU.  Every test needs a card (``cuda``
marker) and skips without one; the file imports no JAX, so it runs
where the card is:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4 (another summation order, and the model's
products in full float32 on both sides); bfloat16 2e-2, about two bf16
ulps of outputs near 1."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as k2
from repro_torch.kernels import ssd_scan as k3
from repro_torch.kernels.ref import flash_attention_plain, ssd_scan_plain

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


def _ssd_inputs(card, B, T, H, G, P, N, dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((B, T, H, P), generator=g, device=card)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, H), generator=g, device=card) - 1)
    A = -torch.exp(torch.randn((H,), generator=g, device=card) * 0.3)
    Bm = torch.randn((B, T, G, N), generator=g, device=card) * 0.5
    Cm = torch.randn((B, T, G, N), generator=g, device=card) * 0.5
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


@pytest.mark.parametrize("T,P,N,chunk,G,dtype", [
    (256, 64, 64, 128, 1, torch.float32),
    (128, 16, 16, 32, 2, torch.float32),
    (64, 16, 16, 64, 4, torch.float32),
    (256, 64, 64, 128, 1, torch.bfloat16),
])
def test_k3_matches_plain(card, T, P, N, chunk, G, dtype):
    ins = _ssd_inputs(card, 2, T, 4, G, P, N, dtype)
    got = k3.ssd_scan_fwd(*ins, chunk=chunk)
    torch.testing.assert_close(got.float(), ssd_scan_plain(*ins).float(),
                               **_tol(dtype))


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
