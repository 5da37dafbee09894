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
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention_fwd
from .ref import (flash_attention_online, masked_select_ref,
                  select_rows_lanes_ref, select_rows_ref,
                  select_rows_window_ref, ssd_chunked)
from .select_move import SelectRows, SelectRowsWindow, masked_select_fwd
from .ssd_scan import ssd_scan_fwd


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


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
    is the plain version's key block; the kernel tiles by its own."""
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
    divide T."""
    if _on_cpu(x, dt, A, Bm, Cm):
        return ssd_chunked(x, dt, A, Bm, Cm, min(chunk, x.shape[1]))[0]
    return ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
