"""K3 on Hopper: the Mamba-2 SSD chunked scan, forward.

:func:`ssd_scan_fwd` launches the CUDA kernel ``csrc/ssd_scan.cu`` — it
replaces the Pallas kernel ``src/repro/kernels/ssd_scan.py::ssd_scan_fwd``
— and :func:`repro_torch.kernels.ref.ssd_scan_ref` is its plain version.
The kernel's source notes its bound and design.
"""

from __future__ import annotations

import ctypes

import torch

#: dynamic shared memory one block may use on an H100 (232,448 bytes:
#: compute capability 9.0 in the CUDA programming guide)
MAX_SMEM_BYTES = 227 * 1024
#: the longest chunk the kernel stages (its Q x Q score tile)
MAX_CHUNK = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_launches = 0


def launch_count() -> int:
    """K3 launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _library():
    from .build import load
    lib = load("ssd_scan")
    if lib.ssd_scan_fwd.argtypes is None:   # pointers must not pass as int
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        lib.ssd_scan_fwd.argtypes = [i, p, p, p, p, p, p,
                                     i, i, i, i, i, i, i] + [ll] * 12 + [p]
        lib.ssd_scan_fwd.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [i, i, i]
        lib.ssd_scan_smem_bytes.restype = ll
    return lib


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, *,
                 chunk: int = 128) -> torch.Tensor:
    """Launch K3 on CUDA tensors.

    x (B, T, H, P), dt (B, T, H), A (H,), Bm/Cm (B, T, G, N) with G
    dividing H (head h reads group h // (H/G)); x, B and C share a dtype
    (float32 or bfloat16) and may be strided views with unit stride over
    their last axis; dt and A are taken to float32.  ``min(chunk, T)``
    must divide T and be at most 128; it, P and N must be multiples of 4.
    Returns y (B, T, H, P) contiguous in x's dtype.  Raises on anything
    else; never falls back to the plain version."""
    global _launches
    if not all(t.is_cuda and t.device == x.device
               for t in (x, dt, A, Bm, Cm)):
        raise ValueError("ssd_scan_fwd needs every operand on one CUDA "
                         "device")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan_fwd: x, B, C dtypes {x.dtype}, "
                         f"{Bm.dtype}, {Cm.dtype}; the kernel takes one of "
                         f"float32 and bfloat16")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 \
            or Cm.shape != Bm.shape:
        raise ValueError("ssd_scan_fwd: bad ranks or shapes")
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dt.shape != (B, T, H) or A.shape != (H,) or Bm.shape[:2] != (B, T) \
            or G < 1 or H % G:
        raise ValueError(f"ssd_scan_fwd: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)} disagree")
    Q = min(chunk, T)
    if T % Q or Q > MAX_CHUNK or Q % 4 or P % 4 or N % 4:
        raise ValueError(f"ssd_scan_fwd: chunk {Q} must divide T {T} and be "
                         f"≤ {MAX_CHUNK}; chunk, P {P} and N {N} multiples "
                         f"of 4")
    if max(T, H) >= 2 ** 31 or B > 65535:
        raise ValueError("ssd_scan_fwd: a dimension exceeds the grid")
    if any(t.stride(3) != 1 for t in (x, Bm, Cm)):
        raise ValueError("ssd_scan_fwd: x, B and C need unit stride over "
                         "their last axis")
    lib = _library()
    smem = lib.ssd_scan_smem_bytes(Q, P, N)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan_fwd: chunk {Q}, P {P}, N {N} need "
                         f"{smem} bytes of shared memory; a block has "
                         f"{MAX_SMEM_BYTES}")
    dt = dt.float()
    A = A.float().contiguous()
    y = torch.empty((B, T, H, P), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_fwd(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), B, T, H, G, P, N, Q,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            Bm.stride(0), Bm.stride(1), Bm.stride(2),
            Cm.stride(0), Cm.stride(1), Cm.stride(2), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    _launches += 1
    return y
