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
  row, so the ``(k, r_cap, n_dev)`` mask never exists.  Given the batch
  engine's legality cache it launches the cached instantiation, which
  reads the candidate masks of the cache's hit blocks and writes the
  others'.  Plain version: :func:`repro_torch.kernels.ref.select_rows_ref`.
* :class:`SelectRowsWindow` — the same selection over one rank's window
  of the destination axis, the sharded engine's
  (:mod:`repro_torch.core.shard`): the source and row side comes from
  tensors the engine gathered for the step, the destination side from
  the rank's block and the device vectors every rank holds.  Plain
  version: :func:`repro_torch.kernels.ref.select_rows_window_ref`.
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

VARIANTS = ("select_rows", "masked_select", "select_rows_window")

_launches = dict.fromkeys(VARIANTS, 0)
#: the ``select_rows`` launches (counted there too) that read a legality
#: cache
_cached_launches = 0


def launch_count() -> int:
    """K1 launches of both kernels since the last
    :func:`reset_launch_count`."""
    return sum(_launches.values())


def launch_counts() -> dict[str, int]:
    """K1 launches by kernel since the last :func:`reset_launch_count`."""
    return dict(_launches)


def cached_launch_count() -> int:
    """The ``select_rows`` launches since the last
    :func:`reset_launch_count` that took the cached instantiation (each is
    in ``launch_counts()["select_rows"]`` too)."""
    return _cached_launches


def reset_launch_count() -> None:
    global _cached_launches
    for name in VARIANTS:
        _launches[name] = 0
    _cached_launches = 0


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
_CACHE = ("cache_ok", "hit_blk", "cache_out")   # per launch, or null
_OUT = ("any_out", "dst_out", "cand_src", "cand_row")
_SIZES = ("k", "R", "n", "S", "L", "rb", "lanes", "n_pg", "P", "n_sh")
#: the per-lane extent of each tensor of a carry stacked on a lane axis
#: (after the leading lane axis), in the sizes' names
_LANE_SHAPES = {"rows_on": ("n", "R"), "acting": ("n_pg", "S"),
                "dst_ok": ("P", "n"), "pool_counts": ("P", "n"),
                "ideal": ("P", "n"), "dev_domain": ("L", "n"),
                "us": (1,), "usq": (1,), "n_f": (), "slack": (),
                "min_dvar": (),
                **{key: ("n",) for key in ("used", "util", "cap", "cap_lim",
                                           "dev_class", "dev_in")},
                **{f"sh_{f}": ("n_sh",) for f in (
                    "pg", "pool", "class", "level", "slot", "sbase", "scnt",
                    "size")}}
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
        if sorted(names) != sorted((*_STEP, *_CARRY, *_CACHE, *_OUT,
                                    *_SIZES)):
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
    reads them from device memory).  ``lanes=True``: every tensor of the
    carry holds carries of one shape stacked on a leading lane axis (the
    fleet's bucket), each scalar one per lane, and one launch selects for
    every lane (no legality cache).  Raises on anything the kernel cannot
    take and never falls back to the plain version."""

    def __init__(self, cap_lim: torch.Tensor, dyn: dict, const: dict,
                 scal: dict, smem_limit: int | None = None,
                 lanes: bool = False):
        self._dicts = {None: {"cap_lim": cap_lim}, "dyn": dyn,
                       "const": const, "scal": scal}
        self._smem_limit = -1 if smem_limit is None else smem_limit
        self._stacked = lanes
        self._bind()

    def _carry(self) -> list[torch.Tensor]:
        return [self._dicts[where][key] for key, (where, _) in _CARRY.items()]

    def _bind(self) -> None:
        held = self._carry()
        dev = held[0].device
        for key, t in zip(_CARRY, held):
            _on_card(key, t, _CARRY[key][1], dev)
        t = dict(zip(_CARRY, held))
        if self._stacked:
            self._bind_lanes(t)
            return
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
        self._held, self._dev, self._R, self._lanes = held, dev, R, None
        self._args = args_type(**{key: v.data_ptr() for key, v in t.items()},
                               R=R, n=n, S=S, L=L, lanes=1,
                               n_pg=t["acting"].shape[0],
                               P=t["dst_ok"].shape[0],
                               n_sh=t["sh_size"].shape[0])

    def _bind_lanes(self, t: dict) -> None:
        """A carry stacked on a lane axis: every tensor's shape must be
        the lanes and one lane's extent (:data:`_LANE_SHAPES`), since the
        kernel finds a lane's data from these sizes alone."""
        def size(key: str, axis: int) -> int:
            shape = t[key].shape
            return shape[axis] if len(shape) > abs(axis) else 0

        B = size("used", 0)
        sizes = {"n": size("used", -1), "R": size("rows_on", -1),
                 "S": size("acting", -1), "L": size("dev_domain", 1),
                 "n_pg": size("acting", 1), "P": size("dst_ok", 1),
                 "n_sh": size("sh_size", -1)}
        bad = {key: tuple(v.shape) for key, v in t.items()
               if tuple(v.shape) != (B, *(d if isinstance(d, int)
                                          else sizes[d]
                                          for d in _LANE_SHAPES[key]))}
        if bad or not 1 <= B < 2 ** 16 or sizes["R"] < 1:
            raise ValueError(f"select_rows: bad shapes for {B} stacked "
                             f"lanes: {bad}")
        self._fn, args_type = _select_rows_kernel()
        self._held, self._dev = list(t.values()), t["used"].device
        self._R, self._lanes = sizes["R"], B
        self._args = args_type(**{key: v.data_ptr() for key, v in t.items()},
                               lanes=B, **sizes)

    def _cache(self, k: int, cache_ok, hit_blk, rb, cache_out) -> int:
        """Check a legality cache for a launch on k sources; returns
        ``rb``."""
        R, n = self._R, self._args.n
        if not isinstance(rb, int) or rb < 1 or R % rb:
            raise ValueError(f"select_rows: the cache's row block {rb!r} "
                             f"must be a positive int dividing R {R}")
        for key, t, shape in (("cache_ok", cache_ok, (k, R, n)),
                              ("hit_blk", hit_blk, (k, R // rb)),
                              ("cache_out", cache_out, (k, R, n))):
            if not isinstance(t, torch.Tensor):
                raise ValueError(f"select_rows: {key} must be a tensor")
            _on_card(key, t, torch.bool, self._dev)
            if tuple(t.shape) != shape:
                raise ValueError(f"select_rows: {key} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
        return rb

    def __call__(self, src_order: torch.Tensor, n_avail: torch.Tensor, *,
                 cache_ok: torch.Tensor | None = None,
                 hit_blk: torch.Tensor | None = None, rb: int | None = None,
                 cache_out: torch.Tensor | None = None,
                 cand_row: bool = False) -> tuple[torch.Tensor, ...]:
        """(any (k · R,) bool, dst (k · R,) int32, cand_src (k,) bool,
        and with ``cand_row`` cand_row (k, R) bool): the outputs of
        :func:`repro_torch.kernels.ref.select_rows_ref` on the same
        arguments.  A ``cache_ok`` launches the cached instantiation; a
        malformed cache raises.  Bound to stacked lanes: ``src_order``
        (lanes, k), ``n_avail`` (lanes,), each output with the leading
        lane axis (:func:`repro_torch.kernels.ref.select_rows_lanes_ref`),
        and no cache."""
        if any(a is not b for a, b in zip(self._carry(), self._held)):
            self._bind()
        if self._lanes is not None:
            return self._call_lanes(src_order, n_avail, cache_ok, hit_blk,
                                    cache_out, cand_row)
        dev = self._dev
        _on_card("src_order", src_order, torch.int64, dev)
        _on_card("n_avail", n_avail, torch.int64, dev)
        k, kR = src_order.shape[0], src_order.shape[0] * self._R
        if src_order.dim() != 1 or n_avail.numel() != 1 or k >= 2 ** 16 \
                or kR >= 2 ** 31:
            raise ValueError(f"select_rows: bad shapes: src_order "
                             f"{tuple(src_order.shape)}, n_avail "
                             f"{tuple(n_avail.shape)}, R {self._R}")
        cached = cache_ok is not None
        if cached:
            cache_out = cache_ok if cache_out is None else cache_out
            rb = self._cache(k, cache_ok, hit_blk, rb, cache_out)
        elif hit_blk is not None or cache_out is not None:
            raise ValueError("select_rows: hit_blk or cache_out without "
                             "cache_ok")
        any_out = torch.empty(kR, dtype=torch.bool, device=dev)
        dst_out = torch.empty(kR, dtype=torch.int32, device=dev)
        cand_src = torch.empty(k, dtype=torch.bool, device=dev)
        rows = (torch.empty((k, self._R), dtype=torch.bool, device=dev)
                if cand_row else None)
        a = self._args         # the launch copies it: reuse is safe
        a.src_order, a.n_avail = src_order.data_ptr(), n_avail.data_ptr()
        a.any_out, a.dst_out = any_out.data_ptr(), dst_out.data_ptr()
        a.cand_src, a.k = cand_src.data_ptr(), k
        a.cand_row = rows.data_ptr() if cand_row else None
        a.cache_ok = cache_ok.data_ptr() if cached else None
        a.hit_blk = hit_blk.data_ptr() if cached else None
        a.cache_out = cache_out.data_ptr() if cached else None
        a.rb = rb if cached else 0
        self._launch()
        if cached:
            global _cached_launches
            _cached_launches += 1
        out = (any_out, dst_out, cand_src)
        return (*out, rows) if cand_row else out

    def _launch(self) -> None:
        with torch.cuda.device(self._dev):
            stream = torch.cuda.current_stream(self._dev).cuda_stream
            rc = self._fn(ctypes.byref(self._args), self._smem_limit, stream)
        if rc != 0:
            raise RuntimeError(f"select_rows kernel launch failed: CUDA "
                               f"error {rc}")
        _launches["select_rows"] += 1

    def _call_lanes(self, src_order, n_avail, cache_ok, hit_blk, cache_out,
                    cand_row: bool) -> tuple[torch.Tensor, ...]:
        """One launch for every stacked lane (the cached instantiation
        takes one carry, never stacked lanes: a cache raises)."""
        if cache_ok is not None or hit_blk is not None \
                or cache_out is not None:
            raise ValueError("select_rows: stacked lanes take no legality "
                             "cache")
        dev, B, R = self._dev, self._lanes, self._R
        _on_card("src_order", src_order, torch.int64, dev)
        _on_card("n_avail", n_avail, torch.int64, dev)
        k = src_order.shape[-1]
        if src_order.shape != (B, k) or n_avail.shape != (B,) \
                or k >= 2 ** 16 or B * k * R >= 2 ** 31:
            raise ValueError(f"select_rows: bad shapes for {B} stacked "
                             f"lanes: src_order {tuple(src_order.shape)}, "
                             f"n_avail {tuple(n_avail.shape)}, R {R}")
        any_out = torch.empty((B, k * R), dtype=torch.bool, device=dev)
        dst_out = torch.empty((B, k * R), dtype=torch.int32, device=dev)
        cand_src = torch.empty((B, k), dtype=torch.bool, device=dev)
        rows = (torch.empty((B, k, R), dtype=torch.bool, device=dev)
                if cand_row else None)
        a = self._args
        a.src_order, a.n_avail = src_order.data_ptr(), n_avail.data_ptr()
        a.any_out, a.dst_out = any_out.data_ptr(), dst_out.data_ptr()
        a.cand_src, a.k = cand_src.data_ptr(), k
        a.cand_row = rows.data_ptr() if cand_row else None
        a.cache_ok = a.hit_blk = a.cache_out = None
        a.rb = 0
        self._launch()
        out = (any_out, dst_out, cand_src)
        return (*out, rows) if cand_row else out


# (dict, dtype) of every carry tensor the window form reads, by its
# field name in SelectRowsWindowArgs; dst_ok is the rank's block
_WINDOW_CARRY = {"dst_ok": ("dyn", torch.bool),
                 "used": ("dyn", torch.float64),
                 "util": ("dyn", torch.float64),
                 "cap": ("const", torch.float64),
                 "cap_lim": (None, torch.float64),
                 "dev_class": ("const", torch.int64),
                 "dev_in": ("const", torch.bool),
                 "dev_domain": ("const", torch.int64),
                 "us": ("dyn", torch.float64), "usq": ("dyn", torch.float64),
                 "n_f": ("scal", torch.float64),
                 "min_dvar": ("scal", torch.float64)}
#: the step's own tensors, set per launch, and their dtypes
_WINDOW_STEP = {"src_order": torch.int64, "n_avail": torch.int64,
                "rows_k": torch.int64, "rec": torch.int64,
                "act_k": torch.int64, "src_ok": torch.bool}
_WINDOW_SIZES = ("k", "R", "n", "S", "L", "P", "base", "n_local")
#: columns of a packed record (``ref.SH_FIELDS``)
_REC_FIELDS = 8
_window_args_type = None


def _select_rows_window_kernel():
    """The C entry ``select_rows_window`` and a ctypes copy of its
    argument struct, built as :func:`_select_rows_kernel` builds
    ``select_rows``'."""
    global _window_args_type
    from .build import load
    lib = load("masked_select")
    fn = lib.select_rows_window
    if _window_args_type is None:
        lib.select_rows_window_fields.restype = ctypes.c_char_p
        lib.select_rows_window_args_bytes.restype = ctypes.c_longlong
        names = lib.select_rows_window_fields().decode().split()
        if sorted(names) != sorted((*_WINDOW_STEP, *_WINDOW_CARRY, *_OUT,
                                    *_WINDOW_SIZES)):
            raise RuntimeError(f"select_rows_window: the library's fields "
                               f"{names} are not the wrapper's")

        class Args(ctypes.Structure):
            _fields_ = [(name, ctypes.c_longlong if name in _WINDOW_SIZES
                         else ctypes.c_void_p) for name in names]

        if ctypes.sizeof(Args) != lib.select_rows_window_args_bytes():
            raise RuntimeError("select_rows_window: the argument struct's "
                               "size differs from the library's")
        fn.argtypes = [ctypes.POINTER(Args), ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _window_args_type = Args
    return fn, _window_args_type


class SelectRowsWindow:
    """K1's window form bound to one rank's carry (``cap_lim``, ``dyn``,
    ``const``, ``scal`` of :class:`repro_torch.core.shard._ShardChunk`):
    the (n,) device vectors whole, ``dyn["dst_ok"]`` the rank's block
    (P, n_local) of the devices from ``base`` on.  Each call launches on
    the step's gathered tensors; a call that finds a tensor of the carry
    replaced checks and packs the carry again.  ``smem_limit`` as
    :class:`SelectRows`'.  There is no legality cache and no lane axis.
    Raises on anything the kernel cannot take and never falls back to the
    plain version or to the unwindowed kernel."""

    def __init__(self, cap_lim: torch.Tensor, dyn: dict, const: dict,
                 scal: dict, base: int, smem_limit: int | None = None):
        self._dicts = {None: {"cap_lim": cap_lim}, "dyn": dyn,
                       "const": const, "scal": scal}
        self._base = base
        self._smem_limit = -1 if smem_limit is None else smem_limit
        self._bind()

    def _carry(self) -> list[torch.Tensor]:
        return [self._dicts[where][key]
                for key, (where, _) in _WINDOW_CARRY.items()]

    def _bind(self) -> None:
        held = self._carry()
        dev = held[0].device
        for key, t in zip(_WINDOW_CARRY, held):
            _on_card(key, t, _WINDOW_CARRY[key][1], dev)
        t = dict(zip(_WINDOW_CARRY, held))
        n, (P, n_local) = t["used"].shape[0], t["dst_ok"].shape
        L = t["dev_domain"].shape[0]
        wide = [key for key in ("used", "util", "cap", "cap_lim",
                                "dev_class", "dev_in")
                if tuple(t[key].shape) != (n,)]
        if wide or t["dev_domain"].shape[1] != n or n_local < 1 \
                or not 0 <= self._base <= n - n_local:
            raise ValueError(f"select_rows_window: bad shapes: n {n}, "
                             f"window [{self._base}, {self._base} + "
                             f"{n_local}), dev_domain "
                             f"{tuple(t['dev_domain'].shape)}, not (n,): "
                             f"{wide}")
        self._fn, args_type = _select_rows_window_kernel()
        self._held, self._dev = held, dev
        self._args = args_type(**{key: v.data_ptr() for key, v in t.items()},
                               n=n, L=L, P=P, base=self._base,
                               n_local=n_local)

    def __call__(self, src_order: torch.Tensor, n_avail: torch.Tensor,
                 rows_k: torch.Tensor, rec: torch.Tensor,
                 act_k: torch.Tensor, src_ok: torch.Tensor, *,
                 cand_row: bool = False) -> tuple[torch.Tensor, ...]:
        """(any (k · R,) bool, dst (k · R,) int32 global, cand_src (k,)
        bool, and with ``cand_row`` cand_row (k, R) bool): the outputs of
        :func:`repro_torch.kernels.ref.select_rows_window_ref` on the same
        arguments."""
        if any(a is not b for a, b in zip(self._carry(), self._held)):
            self._bind()
        dev = self._dev
        step = {"src_order": src_order, "n_avail": n_avail,
                "rows_k": rows_k, "rec": rec, "act_k": act_k,
                "src_ok": src_ok}
        for key, t in step.items():
            _on_card(key, t, _WINDOW_STEP[key], dev)
        k = src_order.shape[0]
        R = rows_k.shape[-1]
        S = act_k.shape[-1]
        if src_order.dim() != 1 or n_avail.numel() != 1 \
                or tuple(rows_k.shape) != (k, R) \
                or tuple(rec.shape) != (k, R, _REC_FIELDS) \
                or tuple(act_k.shape) != (k, R, S) \
                or tuple(src_ok.shape) != (k, R) or R < 1 \
                or k >= 2 ** 16 or k * R >= 2 ** 31:
            raise ValueError(
                f"select_rows_window: bad shapes: src_order "
                f"{tuple(src_order.shape)}, n_avail {tuple(n_avail.shape)}, "
                f"rows_k {tuple(rows_k.shape)}, rec {tuple(rec.shape)}, "
                f"act_k {tuple(act_k.shape)}, src_ok {tuple(src_ok.shape)}")
        any_out = torch.empty(k * R, dtype=torch.bool, device=dev)
        dst_out = torch.empty(k * R, dtype=torch.int32, device=dev)
        cand_src = torch.empty(k, dtype=torch.bool, device=dev)
        rows = (torch.empty((k, R), dtype=torch.bool, device=dev)
                if cand_row else None)
        a = self._args         # the launch copies it: reuse is safe
        for key, t in step.items():
            setattr(a, key, t.data_ptr())
        a.any_out, a.dst_out = any_out.data_ptr(), dst_out.data_ptr()
        a.cand_src = cand_src.data_ptr()
        a.cand_row = rows.data_ptr() if cand_row else None
        a.k, a.R, a.S = k, R, S
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = self._fn(ctypes.byref(a), self._smem_limit, stream)
        if rc != 0:
            raise RuntimeError(f"select_rows_window kernel launch failed: "
                               f"CUDA error {rc}")
        _launches["select_rows_window"] += 1
        out = (any_out, dst_out, cand_src)
        return (*out, rows) if cand_row else out


def select_rows_fwd(src_order: torch.Tensor, n_avail: torch.Tensor,
                    cap_lim: torch.Tensor, dyn: dict, const: dict,
                    scal: dict, smem_limit: int | None = None, **cache
                    ) -> tuple[torch.Tensor, ...]:
    """One launch of the fused selection on the planner's carry, on CUDA
    tensors: the signature and outputs of
    :func:`repro_torch.kernels.ref.select_rows_ref` (``cache``: its
    keyword arguments).  Every tensor must lie on one card, contiguous,
    in the carry's dtype (int64 indices, bool masks, float64 values);
    raises on anything else and never falls back to the plain version or
    to the other instantiation.  A planner that launches once a step
    binds its carry once instead (:class:`SelectRows`)."""
    return SelectRows(cap_lim, dyn, const, scal, smem_limit)(
        src_order, n_avail, **cache)


def compact_parked(order_k: torch.Tensor, parked: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable partition of the top-k source ranks by a per-rank
    ``parked`` mask: unparked ranks first (fullest-first order
    preserved), parked ranks at the back.

    order_k: (..., k) device indices, fullest first, along the last axis
    (the fleet stacks lanes before it).  parked: the same shape, one flag
    per *rank*.  Returns (compacted order, int64 count of unparked ranks
    with the last axis dropped: 0-dim for one order).  Each rank's
    destination slot comes from two running counts (no sort, no host
    sync), and one scatter places it.
    """
    keep = ~parked
    n_keep = keep.sum(dim=-1)
    slot = torch.where(keep, torch.cumsum(keep, -1) - 1,
                       n_keep[..., None] + torch.cumsum(parked, -1) - 1)
    out = torch.empty_like(order_k).scatter_(-1, slot, order_k)
    return out, n_keep


def compact_sources(order_k: torch.Tensor, pruned: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable partition of the top-k source ranks so unpruned sources
    come first and pruned sources are parked at the back.

    order_k: (k,) device indices, fullest first.  pruned: (n_dev,) bool.
    Returns (compacted (k,) order, 0-dim int64 count of unpruned
    sources)."""
    return compact_parked(order_k, pruned[order_k])
