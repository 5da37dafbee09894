"""The kernel dispatch the engines and the model call.

The one place that chooses between a kernel and its plain version: a
call whose tensors lie on the CPU takes the plain version (:mod:`.ref`,
the same schedule as the reference model's code); a call on CUDA tensors
launches the hand-written kernel or raises.  There is no fallback from a
failed build or launch.

* K1 :func:`select_rows` — the batched planner step's selection, every
  criterion and the reduction in one launch (:func:`bind_select_rows`
  binds it to a carry once, or to a bucket of stacked carries;
  :func:`bind_select_rows_window` to one rank's window of the sharded
  engine's carry) — and :func:`masked_select`,
  the reduction alone over a legality mask;
* K2 :func:`flash_attention` — attention forward (model layout);
* K3 :func:`ssd_scan` — the Mamba-2 SSD chunked scan (model layout).

Training.  When an input of K2 or K3 requires a gradient (and grad mode
is on), the call goes through an autograd function, :class:`FlashAttention`
or :class:`SSDScan`, whose forward is the same kernel (or, on the CPU,
the same plain version) and whose backward is plain PyTorch on every
device.  The reference's backwards are ``jnp`` outside any Pallas
kernel: attention's is the custom VJP ``_flash_bwd_impl``
(``src/repro/models/layers.py:175-208``), here
:func:`.ref.flash_attention_bwd_plain` over the forward's saved ``out``
and log-sum-exp (K2 writes it); the SSD scan's is autodiff of
``ssd_chunked`` under ``jax.checkpoint``, which recomputes the jnp
forward inside the backward (``src/repro/models/ssm.py:133-141``), here
:func:`.ref.ssd_chunked` recomputed under ``torch.enable_grad()`` and
differentiated.  Hand-written backward kernels are later performance
work, not a port of a TPU kernel.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention_fwd
from .ref import (flash_attention_bwd_plain, flash_attention_online,
                  masked_select_ref,
                  select_rows_lanes_ref, select_rows_ref,
                  select_rows_window_ref, ssd_chunked)
from .select_move import SelectRows, SelectRowsWindow, masked_select_fwd
from .ssd_scan import ssd_scan_fwd


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _differentiated(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def masked_select(valid: torch.Tensor, util: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked move-selection reduction (the batched planner's inner
    kernel): valid (M, D) bool/uint8, util (D,) → (any (M,) bool,
    dst (M,) int32) — per candidate row, whether any destination is
    legal and the emptiest legal destination (min util, ties → lowest
    device index, 0 where none is legal)."""
    if _on_cpu(valid, util):
        return masked_select_ref(valid, util)
    return masked_select_fwd(valid, util)


def bind_select_rows(cap_lim: torch.Tensor, dyn: dict, const: dict,
                     scal: dict, lanes: bool = False):
    """The batched planner step's selection bound to its carry: a
    callable ``(src_order, n_avail, **cache) → (any, dst, cand_src[,
    cand_row])`` (see :func:`select_rows`).  On a carry on the CPU it runs
    the plain version, on one on a card it launches the kernel
    (:class:`.select_move.SelectRows`, which checks the carry once).
    ``lanes=True``: the carry's tensors are stacked on a leading lane
    axis (the fleet's bucket), one launch selects for every lane, and
    each output carries the lane axis (plain version
    :func:`.ref.select_rows_lanes_ref`)."""
    if _on_cpu(cap_lim, dyn["util"]):
        plain = select_rows_lanes_ref if lanes else select_rows_ref
        return lambda src_order, n_avail, **cache: plain(
            src_order, n_avail, cap_lim, dyn, const, scal, **cache)
    return SelectRows(cap_lim, dyn, const, scal, lanes=lanes)


def bind_select_rows_window(cap_lim: torch.Tensor, dyn: dict, const: dict,
                            scal: dict, base: int):
    """The sharded engine's selection over one rank's window of the
    destination axis, bound to the rank's carry: a callable
    ``(src_order, n_avail, rows_k, rec, act_k, src_ok, cand_row=False) →
    (any, dst, cand_src[, cand_row])`` with global ``dst``
    (:func:`.ref.select_rows_window_ref` says what each holds).  On a
    carry on the CPU it runs the plain version, on one on a card it
    launches the kernel (:class:`.select_move.SelectRowsWindow`)."""
    if _on_cpu(cap_lim, dyn["util"]):
        return lambda *step, **kw: select_rows_window_ref(
            *step, cap_lim, dyn, const, scal, base=base, **kw)
    return SelectRowsWindow(cap_lim, dyn, const, scal, base)


def select_rows(src_order: torch.Tensor, n_avail: torch.Tensor,
                cap_lim: torch.Tensor, dyn: dict, const: dict, scal: dict,
                **cache) -> tuple[torch.Tensor, ...]:
    """The batched planner step's selection over its carry: per row of
    the k sources ``src_order`` (the first ``n_avail`` available), ``any``
    (k · r_cap,) bool, ``dst`` (k · r_cap,) int32 and, per source,
    ``cand_src`` (k,) bool; ``cache`` holds the legality cache and the
    ``cand_row`` flag (:func:`.ref.select_rows_ref` says what each
    holds)."""
    return bind_select_rows(cap_lim, dyn, const, scal)(src_order, n_avail,
                                                      **cache)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    cap: float | None = None,
                    scale: float | None = None,
                    kv_block: int = 512) -> torch.Tensor:
    """Model layout: q (B, T, H, Dh), k/v (B, Tk, KV, Dh) → (B, T, H, Dh)
    in q's dtype.  GQA k/v serve H // KV query heads each.  ``kv_block``
    is the plain version's key block; the kernel tiles by its own.  A
    call with an input that requires a gradient goes through
    :class:`FlashAttention`."""
    if _differentiated(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, cap, scale,
                                    kv_block)
    if _on_cpu(q, k, v):
        return flash_attention_online(q, k, v, causal=causal, window=window,
                                      cap=cap, scale=scale,
                                      kv_block=kv_block)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               cap=cap, scale=scale)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """Model layout: x (B, T, H, P), dt (B, T, H), A (H,), B/C
    (B, T, G, N) → y (B, T, H, P) in x's dtype; ``min(chunk, T)`` must
    divide T.  A call with an input that requires a gradient goes through
    :class:`SSDScan`."""
    if _differentiated(x, dt, A, Bm, Cm):
        return SSDScan.apply(x, dt, A, Bm, Cm, chunk)
    if _on_cpu(x, dt, A, Bm, Cm):
        return ssd_chunked(x, dt, A, Bm, Cm, min(chunk, x.shape[1]))[0]
    return ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)


class FlashAttention(torch.autograd.Function):
    """K2 with a backward pass.  Forward: on CUDA tensors K2 with its
    log-sum-exp; on the CPU the plain online version, which returns the
    float32 ``out`` before its cast, as the reference's ``_fa_forward``
    does.  It saves q, k, v, out and lse.  Backward:
    :func:`.ref.flash_attention_bwd_plain` on either device.  On the card
    ``out`` is K2's output in q's dtype, cast to float32 there: in bf16,
    ``delta = Σ dout·out`` carries out's rounding, which the reference's
    float32 ``out`` does not (``chip_smoke.py`` phase ``train`` (b) and
    ``tests/test_torch_cuda.py`` state what it costs)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, scale, kv_block):
        kw = dict(causal=causal, window=window, cap=cap, scale=scale)
        if _on_cpu(q, k, v):
            out32, lse = flash_attention_online(q, k, v, kv_block=kv_block,
                                                with_lse=True, **kw)
            out = out32.to(q.dtype)
        else:
            out, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
            out32 = out
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.kw = dict(kw, kv_block=kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                               **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


class SSDScan(torch.autograd.Function):
    """K3 with a backward pass.  Forward: K3 on CUDA tensors, the plain
    chunk loop on the CPU; it saves the inputs.  Backward: the plain
    :func:`.ref.ssd_chunked` recomputed from them under
    ``torch.enable_grad()`` and differentiated with
    ``torch.autograd.grad`` (the reference's ``jax.checkpoint`` of the
    superchunk body recomputes its jnp forward the same way)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        if _on_cpu(x, dt, A, Bm, Cm):
            return ssd_chunked(x, dt, A, Bm, Cm, min(chunk, x.shape[1]))[0]
        return ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = ssd_chunked(*inputs, min(ctx.chunk, inputs[0].shape[1]))[0]
        grads = iter(torch.autograd.grad(y, wanted, dy))
        return (*(next(grads) if t.requires_grad else None
                  for t in inputs), None)
