"""K2 on Hopper: the flash-attention forward.

:func:`flash_attention_fwd` launches a CUDA kernel of
``csrc/flash_attention.cu`` — it replaces the Pallas kernel
``src/repro/kernels/flash_attention.py::flash_attention_fwd`` — and
:func:`repro_torch.kernels.ref.flash_attention_ref` is its plain version.
The kernels' source notes their bound and design.

Two variants, chosen by :func:`route` from the dtype and the head width
alone:

* ``"tensor_core"`` (``flash_attention_fwd_tc``: TMA, wgmma) for bf16 q,
  k and v with Dh a multiple of 16 in 16..128.  TMA reads the operands,
  so their data pointers and (B, T, head) strides must be positive
  multiples of 16 bytes: :func:`.tma.check_tma_layout` raises on any other
  layout, and such a call never goes to the other variant;
* ``"simt"`` (``flash_attention_fwd``) for float32 and every other head
  width (Dh 256, Dh not a multiple of 16).

Each variant counts its own launches (:func:`launch_counts`).  Either
writes, on request (``with_lse=True``), the float32 log-sum-exp of each
query row, (B, H, Tq): the residual the training backward reads
(:class:`repro_torch.kernels.ops.FlashAttention`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .ref import NO_WINDOW
from .tma import check_tma_layout

#: the largest head dim the SIMT kernel's register tiles cover
MAX_HEAD_DIM = 256
#: the head widths of the tensor-core kernel (at most two 64-column boxes)
TC_HEAD_DIMS = range(16, 129, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("tensor_core", "simt")
_ENTRY = {"tensor_core": "flash_attention_fwd_tc",
          "simt": "flash_attention_fwd"}

_launches = dict.fromkeys(VARIANTS, 0)


def launch_count() -> int:
    """K2 launches of both variants since the last
    :func:`reset_launch_count`."""
    return sum(_launches.values())


def launch_counts() -> dict[str, int]:
    """K2 launches by variant since the last :func:`reset_launch_count`."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in VARIANTS:
        _launches[name] = 0


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The variant a call of ``dtype`` and head width ``head_dim`` takes:
    ``"tensor_core"`` for bfloat16 with Dh in :data:`TC_HEAD_DIMS`, else
    ``"simt"``.  Nothing else (layout, sequence length, masks) enters."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tensor_core"
    return "simt"


def _kernel(variant: str):
    from .build import load
    fn = getattr(load("flash_attention"), _ENTRY[variant])
    if fn.argtypes is None:             # pointers must not pass as int
        ll, i, f, p = (ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p)
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll,
                       f, i, i, i, f, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        cap: float | None = None,
                        scale: float | None = None, with_lse: bool = False
                        ) -> torch.Tensor | tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Launch K2 on CUDA tensors.

    q (B, Tq, H, Dh), k/v (B, Tk, KV, Dh) with KV dividing H (head h
    reads kv head h // (H/KV)), any strides with unit stride over Dh →
    (B, Tq, H, Dh) contiguous, in q's dtype; with ``with_lse`` also the
    rows' float32 log-sum-exp (B, H, Tq) as a second output (the natural
    log over the scaled, capped, masked logits).  float32 or bfloat16,
    Dh ≤ 256, window ≥ 1; :func:`route` picks the variant.  Raises on
    anything else, and on a tensor-core call that TMA cannot read; never
    falls back to the plain version or to the other variant."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd needs q, k and v on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes one of float32 and "
                         f"bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd: bad shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    B, Tq, H, Dh = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != Dh or KV < 1 or H % KV:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    if not 1 <= Dh <= MAX_HEAD_DIM or Tk < 1:
        raise ValueError(f"flash_attention_fwd: Dh {Dh} (1..{MAX_HEAD_DIM})"
                         f", Tk {Tk}")
    if max(B, Tq, Tk, H) >= 2 ** 31 or H > 65535 or B > 65535:
        raise ValueError("flash_attention_fwd: a dimension exceeds the grid")
    if any(t.stride(3) != 1 for t in (q, k, v) if Dh > 1):
        raise ValueError("flash_attention_fwd: q, k and v need unit stride "
                         "over Dh")
    win = NO_WINDOW if window is None else int(window)
    if not 1 <= win <= NO_WINDOW:
        raise ValueError(f"flash_attention_fwd: window {window} must be ≥ 1")
    variant = route(q.dtype, Dh)
    if variant == "tensor_core":
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma_layout(name, t.data_ptr(), t.stride()[:3],
                             t.element_size())
    scale = 1.0 / math.sqrt(Dh) if scale is None else float(scale)
    out = torch.empty((B, Tq, H, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    fn = _kernel(variant)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), None if lse is None else lse.data_ptr(),
                B, Tq, Tk, H, KV, Dh,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                scale, int(bool(causal)), win, int(cap is not None),
                0.0 if cap is None else float(cap), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention {variant} kernel launch "
                           f"failed: CUDA error {rc}")
    _launches[variant] += 1
    return out if lse is None else (out, lse)
