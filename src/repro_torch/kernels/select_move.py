"""K1 on Hopper: the masked move-selection reduction, and the
source-queue stable partition of the batched planner.

The device-resident Equilibrium engine (:mod:`repro_torch.core
.equilibrium_batch`) evaluates a ``(k · r_cap, n_dev)`` legality matrix
per planning step and needs, per candidate shard row, ``any`` (a legal
destination exists) and ``dst`` (the emptiest legal destination, ties to
the lowest device index).  :func:`masked_select_fwd` launches the CUDA
kernel ``csrc/masked_select.cu`` for that — it replaces the Pallas kernel
``src/repro/kernels/select_move.py::masked_select_fwd`` — and
:func:`repro_torch.kernels.ref.masked_select_ref` is its plain version.
The kernel's source notes its bound and design.

:func:`compact_parked` / :func:`compact_sources` are tensor code: a
stable partition of the top-k source ranks (k is a handful of lanes).
"""

from __future__ import annotations

import ctypes

import torch

_launches = 0


def launch_count() -> int:
    """K1 launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _kernel(dtype: torch.dtype):
    from .build import load
    lib = load("masked_select")
    fn = lib.masked_select_f64 if dtype == torch.float64 \
        else lib.masked_select_f32
    if fn.argtypes is None:             # pointers must not pass as int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def masked_select_fwd(valid: torch.Tensor, util: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on CUDA tensors: valid (M, D) bool/uint8 with unit
    column stride, util (D,) contiguous float32/float64 on the same card
    → (any (M,) bool, dst (M,) int32).  Raises on anything else; never
    falls back to the plain version."""
    global _launches
    if not (valid.is_cuda and util.is_cuda and valid.device == util.device):
        raise ValueError("masked_select_fwd needs valid and util on one "
                         "CUDA device")
    if valid.dim() != 2 or util.dim() != 1 \
            or util.shape[0] != valid.shape[1]:
        raise ValueError(f"masked_select_fwd: bad shapes valid "
                         f"{tuple(valid.shape)}, util {tuple(util.shape)}")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"masked_select_fwd: valid dtype {valid.dtype}")
    if util.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"masked_select_fwd: util dtype {util.dtype}")
    M, D = valid.shape
    if M >= 2 ** 31 or D >= 2 ** 31:
        raise ValueError("masked_select_fwd: dimension exceeds int32")
    if D > 1 and valid.stride(1) != 1:
        raise ValueError("masked_select_fwd: valid needs unit column stride")
    if not util.is_contiguous():
        raise ValueError("masked_select_fwd: util must be contiguous")
    any_out = torch.empty(M, dtype=torch.bool, device=valid.device)
    dst_out = torch.empty(M, dtype=torch.int32, device=valid.device)
    fn = _kernel(util.dtype)
    with torch.cuda.device(valid.device):
        stream = torch.cuda.current_stream(valid.device).cuda_stream
        rc = fn(valid.data_ptr(), valid.stride(0), util.data_ptr(), M, D,
                any_out.data_ptr(), dst_out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"masked_select kernel launch failed: CUDA "
                           f"error {rc}")
    _launches += 1
    return any_out, dst_out


def compact_parked(order_k: torch.Tensor, parked: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable partition of the top-k source ranks by a per-rank
    ``parked`` mask: unparked ranks first (fullest-first order
    preserved), parked ranks at the back.

    order_k: (k,) device indices, fullest first.  parked: (k,) bool, one
    flag per *rank*.  Returns (compacted (k,) order, 0-dim int64 count
    of unparked ranks).  Each rank's destination slot comes from two
    running counts (no sort, no host sync), and one scatter places it.
    """
    keep = ~parked
    n_keep = keep.sum()
    slot = torch.where(keep, torch.cumsum(keep, 0) - 1,
                       n_keep + torch.cumsum(parked, 0) - 1)
    out = torch.empty_like(order_k).scatter_(0, slot, order_k)
    return out, n_keep


def compact_sources(order_k: torch.Tensor, pruned: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable partition of the top-k source ranks so unpruned sources
    come first and pruned sources are parked at the back.

    order_k: (k,) device indices, fullest first.  pruned: (n_dev,) bool.
    Returns (compacted (k,) order, 0-dim int64 count of unpruned
    sources)."""
    return compact_parked(order_k, pruned[order_k])
