"""K3 on Hopper: the Mamba-2 SSD chunked scan, forward.

:func:`ssd_scan_fwd` launches a CUDA kernel of ``csrc/ssd_scan.cu`` — it
replaces the Pallas kernel ``src/repro/kernels/ssd_scan.py::ssd_scan_fwd``
— and :func:`repro_torch.kernels.ref.ssd_scan_ref` is its plain version.
The kernels' source notes their bound and design.

Two variants, chosen by :func:`route` from the dtype, P, N and the chunk
alone:

* ``"tensor_core"`` (``ssd_scan_fwd_tc``: TMA, wgmma, one block per
  chunk and head, the state handed on from chunk to chunk through a ring
  of :data:`K3_RING` slots per (batch, head)) for bf16 x, B and C with P
  in :data:`TC_P`, N in :data:`TC_N` and the chunk in :data:`TC_CHUNKS`:
  the bf16 prefills of zamba2-7b (N 64) and mamba2-2.7b (N 128).  TMA
  reads x, B and C, so their data pointers and (B, T, head or group)
  strides must be positive multiples of 16 bytes:
  :func:`.tma.check_tma_layout`, K2's rule too, raises on any other
  layout, and such a call never goes to the other variant.  Its
  workspace, :func:`workspace_bytes`, does not grow with T;
* ``"simt"`` (``ssd_scan_fwd``) for float32 and every other shape (N
  256, P 128, chunks outside :data:`TC_CHUNKS`), with N tiled inside the
  block: its shared memory (``ssd_scan_smem_bytes`` of the library) fits
  every chunk up to 128 with P and N multiples of 4 and N up to 256.

Each variant counts its own launches (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes

import torch

from .tma import check_tma_layout

#: dynamic shared memory one block may use on an H100 (232,448 bytes:
#: compute capability 9.0 in the CUDA programming guide)
MAX_SMEM_BYTES = 227 * 1024
#: the longest chunk the kernel stages (its Q x Q score tile)
MAX_CHUNK = 128
#: P of the tensor-core kernel (one 64-column TMA box, one wgmma N)
TC_P = (64,)
#: N of the tensor-core kernel (one or two 64-column boxes of C, B and
#: the state)
TC_N = (64, 128)
#: chunks of the tensor-core kernel (one or two 64-row warpgroups)
TC_CHUNKS = (64, 128)
#: slots of the tensor-core kernel's state hand-off ring per (batch, head),
#: passed to the kernel (``Params::ring`` in ``csrc/ssd_scan.cu`` argues
#: why two are enough)
K3_RING = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("tensor_core", "simt")

_launches = dict.fromkeys(VARIANTS, 0)


def launch_count() -> int:
    """K3 launches of both variants since the last
    :func:`reset_launch_count`."""
    return sum(_launches.values())


def launch_counts() -> dict[str, int]:
    """K3 launches by variant since the last :func:`reset_launch_count`."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in VARIANTS:
        _launches[name] = 0


def route(dtype: torch.dtype, P: int, N: int, chunk: int) -> str:
    """The variant a call of ``dtype``, head width ``P``, state width
    ``N`` and chunk ``chunk`` (already cut to T) takes: ``"tensor_core"``
    for bfloat16 with P in :data:`TC_P`, N in :data:`TC_N` and the chunk
    in :data:`TC_CHUNKS`, else ``"simt"``.  Nothing else (layout, T,
    heads, groups) enters."""
    if dtype == torch.bfloat16 and P in TC_P and N in TC_N \
            and chunk in TC_CHUNKS:
        return "tensor_core"
    return "simt"


def workspace_bytes(B: int, H: int, T: int, P: int, N: int, Q: int) -> int:
    """Bytes of the workspace one tensor-core call allocates: the
    float32 (P, N) state ring, :data:`K3_RING` slots per (batch, head),
    then one int32 counter per (batch, head) and the ticket counter.  T
    and the chunk Q do not enter: the ring holds the chunks in flight,
    not the sequence."""
    del T, Q
    return B * H * K3_RING * P * N * 4 + (B * H + 1) * 4


def _library():
    from .build import load
    lib = load("ssd_scan")
    if lib.ssd_scan_fwd.argtypes is None:   # pointers must not pass as int
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        lib.ssd_scan_fwd.argtypes = [i, p, p, p, p, p, p,
                                     i, i, i, i, i, i, i] + [ll] * 12 + [p]
        lib.ssd_scan_fwd.restype = ctypes.c_int
        lib.ssd_scan_fwd_tc.argtypes = [p] * 7 + [i, p] + [i] * 7 \
            + [ll] * 12 + [p]
        lib.ssd_scan_fwd_tc.restype = ctypes.c_int
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
    :func:`route` picks the variant.  Returns y (B, T, H, P) contiguous in
    x's dtype.  Raises on anything else, and on a tensor-core call that TMA
    cannot read; never falls back to the plain version or to the other
    variant."""
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
    variant = route(x.dtype, P, N, Q)
    if variant == "tensor_core":
        for name, t in (("x", x), ("B", Bm), ("C", Cm)):
            check_tma_layout(name, t.data_ptr(), t.stride()[:3],
                             t.element_size())
    lib = _library()
    if variant == "simt":
        smem = lib.ssd_scan_smem_bytes(Q, P, N)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"ssd_scan_fwd: chunk {Q}, P {P}, N {N} need "
                             f"{smem} bytes of shared memory; a block has "
                             f"{MAX_SMEM_BYTES}")
    dt = dt.float()
    A = A.float().contiguous()
    y = torch.empty((B, T, H, P), dtype=x.dtype, device=x.device)
    strides = (x.stride(0), x.stride(1), x.stride(2),
               dt.stride(0), dt.stride(1), dt.stride(2),
               Bm.stride(0), Bm.stride(1), Bm.stride(2),
               Cm.stride(0), Cm.stride(1), Cm.stride(2))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if variant == "tensor_core":
            # the state ring; after it the (B, H) counters that publish
            # its slots and the counter the blocks draw their tickets
            # from, both zero at launch
            ws = torch.empty(workspace_bytes(B, H, T, P, N, Q),
                             dtype=torch.uint8, device=x.device)
            ring = B * H * K3_RING * P * N * 4
            ws[ring:].zero_()
            rc = lib.ssd_scan_fwd_tc(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), ws.data_ptr(), K3_RING,
                ws.data_ptr() + ring, B, T, H, G, P, N, Q, *strides, stream)
        else:
            rc = lib.ssd_scan_fwd(
                _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), B, T, H, G, P, N,
                Q, *strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan {variant} kernel launch failed: CUDA "
                           f"error {rc}")
    _launches[variant] += 1
    return y
