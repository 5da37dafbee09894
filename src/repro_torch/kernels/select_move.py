"""K1 on Hopper: the batched planner's move selection, and the
source-queue stable partition.

The device-resident Equilibrium engine (:mod:`repro_torch.core
.equilibrium_batch`) needs, per planning step and per candidate shard row
of its top-k sources, ``any`` (a legal destination exists) and ``dst``
(the emptiest legal destination, ties to the lowest device index).  Both
functions below launch a CUDA kernel of ``csrc/masked_select.cu`` in
place of the Pallas kernel ``src/repro/kernels/select_move.py::
masked_select_fwd``; the kernels' source notes their bound and design.

* :class:`SelectRows` (one call: :func:`select_rows_fwd`) — the planner
  step's path: one fused launch evaluates every legality criterion and
  the float64 variance test on the carry as it stands and reduces per
  row, so the ``(k, r_cap, n_dev)`` mask never exists.  Plain version:
  :func:`repro_torch.kernels.ref.select_rows_ref`.
* :func:`masked_select_fwd` — the reduction alone over a mask in device
  memory, the counterpart of the JAX package's public function.  Plain
  version: :func:`repro_torch.kernels.ref.masked_select_ref`.

Each counts its own launches (:func:`launch_counts`).

:func:`compact_parked` / :func:`compact_sources` are tensor code: a
stable partition of the top-k source ranks (k is a handful of lanes).
"""

from __future__ import annotations

import ctypes

import torch

VARIANTS = ("select_rows", "masked_select")

_launches = dict.fromkeys(VARIANTS, 0)


def launch_count() -> int:
    """K1 launches of both kernels since the last
    :func:`reset_launch_count`."""
    return sum(_launches.values())


def launch_counts() -> dict[str, int]:
    """K1 launches by kernel since the last :func:`reset_launch_count`."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in VARIANTS:
        _launches[name] = 0


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
    """Launch K1's reduction on CUDA tensors: valid (M, D) bool/uint8
    with unit column stride, util (D,) contiguous float32/float64 on the
    same card → (any (M,) bool, dst (M,) int32).  Raises on anything
    else; never falls back to the plain version."""
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
    _launches["masked_select"] += 1
    return any_out, dst_out


# (dict, dtype) of every carry tensor select_rows reads, by its field name
# in SelectRowsArgs (csrc/masked_select.cu); "cap_lim" is the engine's
# own tensor, passed on its own
_CARRY = {"rows_on": ("dyn", torch.int64), "acting": ("dyn", torch.int64),
          "dst_ok": ("dyn", torch.bool),
          "pool_counts": ("dyn", torch.float64),
          "ideal": ("const", torch.float64), "used": ("dyn", torch.float64),
          "util": ("dyn", torch.float64), "cap": ("const", torch.float64),
          "cap_lim": (None, torch.float64),
          "dev_class": ("const", torch.int64),
          "dev_in": ("const", torch.bool),
          "dev_domain": ("const", torch.int64),
          **{f"sh_{f}": ("const", torch.int64) for f in (
              "pg", "pool", "class", "level", "slot", "sbase", "scnt")},
          "sh_size": ("const", torch.float64), "us": ("dyn", torch.float64),
          "usq": ("dyn", torch.float64), "n_f": ("scal", torch.float64),
          "slack": ("scal", torch.float64),
          "min_dvar": ("scal", torch.float64)}
_STEP = ("src_order", "n_avail")         # the step's own, set per launch
_OUT = ("any_out", "dst_out", "cand_src")
_SIZES = ("k", "R", "n", "S", "L")
_args_type = None


def _select_rows_kernel():
    """The C entry ``select_rows`` and a ctypes copy of its argument
    struct, built from the field names the library gives
    (``select_rows_fields``) and checked against its size."""
    global _args_type
    from .build import load
    lib = load("masked_select")
    fn = lib.select_rows
    if _args_type is None:
        lib.select_rows_fields.restype = ctypes.c_char_p
        lib.select_rows_args_bytes.restype = ctypes.c_longlong
        names = lib.select_rows_fields().decode().split()
        if sorted(names) != sorted((*_STEP, *_CARRY, *_OUT, *_SIZES)):
            raise RuntimeError(f"select_rows: the library's fields {names} "
                               f"are not the wrapper's")

        class Args(ctypes.Structure):
            _fields_ = [(name, ctypes.c_longlong if name in _SIZES
                         else ctypes.c_void_p) for name in names]

        if ctypes.sizeof(Args) != lib.select_rows_args_bytes():
            raise RuntimeError("select_rows: the argument struct's size "
                               "differs from the library's")
        fn.argtypes = [ctypes.POINTER(Args), ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _args_type = Args
    return fn, _args_type


def _on_card(key: str, t: torch.Tensor, dtype: torch.dtype,
             dev: torch.device) -> None:
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"select_rows needs every tensor on one CUDA "
                         f"device: {key} is on {t.device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"select_rows: {key} must be contiguous {dtype}, "
                         f"got {t.dtype}")


class SelectRows:
    """K1's fused selection bound to one planner carry (``cap_lim``,
    ``dyn``, ``const``, ``scal``).  The carry is checked and its pointers
    packed once; each call launches on the step's ``src_order`` and
    ``n_avail``.  The planner updates the carry in place within a chunk;
    a call that finds a tensor of it replaced (a re-pad) checks and packs
    the carry again.  ``smem_limit``: the bytes of shared memory a block
    may stage the device vectors in (None: the device's own limit; 0
    reads them from device memory).  Raises on anything the kernel cannot
    take and never falls back to the plain version."""

    def __init__(self, cap_lim: torch.Tensor, dyn: dict, const: dict,
                 scal: dict, smem_limit: int | None = None):
        self._dicts = {None: {"cap_lim": cap_lim}, "dyn": dyn,
                       "const": const, "scal": scal}
        self._smem_limit = -1 if smem_limit is None else smem_limit
        self._bind()

    def _carry(self) -> list[torch.Tensor]:
        return [self._dicts[where][key] for key, (where, _) in _CARRY.items()]

    def _bind(self) -> None:
        held = self._carry()
        dev = held[0].device
        for key, t in zip(_CARRY, held):
            _on_card(key, t, _CARRY[key][1], dev)
        t = dict(zip(_CARRY, held))
        n, R = t["used"].shape[0], t["rows_on"].shape[1]
        S, L = t["acting"].shape[1], t["dev_domain"].shape[0]
        # every per-device axis is n long (rows_on's first, the others'
        # last)
        widths = {key: t[key].shape[-1] for key in (
            "dst_ok", "pool_counts", "ideal", "util", "cap", "cap_lim",
            "dev_class", "dev_in", "dev_domain")}
        widths["rows_on"] = t["rows_on"].shape[0]
        per_device = [key for key, width in widths.items() if width != n]
        if per_device or R < 1:
            raise ValueError(f"select_rows: bad shapes: rows_on "
                             f"{tuple(t['rows_on'].shape)}, n {n}, not n "
                             f"wide: {per_device}")
        self._fn, args_type = _select_rows_kernel()
        self._held, self._dev, self._R = held, dev, R
        self._args = args_type(**{key: v.data_ptr() for key, v in t.items()},
                               R=R, n=n, S=S, L=L)

    def __call__(self, src_order: torch.Tensor, n_avail: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(any (k · R,) bool, dst (k · R,) int32, cand_src (k,) bool):
        the outputs of :func:`repro_torch.kernels.ref.select_rows_ref`."""
        if any(a is not b for a, b in zip(self._carry(), self._held)):
            self._bind()
        dev = self._dev
        _on_card("src_order", src_order, torch.int64, dev)
        _on_card("n_avail", n_avail, torch.int64, dev)
        k, kR = src_order.shape[0], src_order.shape[0] * self._R
        if src_order.dim() != 1 or n_avail.numel() != 1 or k >= 2 ** 16 \
                or kR >= 2 ** 31:
            raise ValueError(f"select_rows: bad shapes: src_order "
                             f"{tuple(src_order.shape)}, n_avail "
                             f"{tuple(n_avail.shape)}, R {self._R}")
        any_out = torch.empty(kR, dtype=torch.bool, device=dev)
        dst_out = torch.empty(kR, dtype=torch.int32, device=dev)
        cand_src = torch.empty(k, dtype=torch.bool, device=dev)
        a = self._args         # the launch copies it: reuse is safe
        a.src_order, a.n_avail = src_order.data_ptr(), n_avail.data_ptr()
        a.any_out, a.dst_out = any_out.data_ptr(), dst_out.data_ptr()
        a.cand_src, a.k = cand_src.data_ptr(), k
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = self._fn(ctypes.byref(a), self._smem_limit, stream)
        if rc != 0:
            raise RuntimeError(f"select_rows kernel launch failed: CUDA "
                               f"error {rc}")
        _launches["select_rows"] += 1
        return any_out, dst_out, cand_src


def select_rows_fwd(src_order: torch.Tensor, n_avail: torch.Tensor,
                    cap_lim: torch.Tensor, dyn: dict, const: dict,
                    scal: dict, smem_limit: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the fused selection on the planner's carry, on CUDA
    tensors: the signature and outputs of
    :func:`repro_torch.kernels.ref.select_rows_ref`.  Every tensor must
    lie on one card, contiguous, in the carry's dtype (int64 indices,
    bool masks, float64 values); raises on anything else and never falls
    back to the plain version.  A planner that launches once a step binds
    its carry once instead (:class:`SelectRows`)."""
    return SelectRows(cap_lim, dyn, const, scal, smem_limit)(src_order,
                                                            n_avail)


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
