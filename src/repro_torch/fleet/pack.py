"""Shape-bucketed packing of batch-engine carries into stacked tensors.

The port's batch carry (:class:`repro_torch.core.equilibrium_batch._Chunk`:
the dicts ``dyn``, ``const`` and ``scal``) holds tensors whose shapes are
a cluster's natural dimensions (devices, shard rows, PGs, pools, ...).
One step over many clusters needs them in one shape, so this module:

* rounds each cluster's :class:`CarryDims` up to a power-of-two
  :class:`BucketShape` (clusters of similar size share a bucket, which
  stays stable while clusters join and leave the fleet);
* pads each carry to its bucket shape with **neutral values**, chosen so
  padding can never change a plan: pad devices are not ``in`` (never
  destinations), hold no rows (never winning sources), carry
  utilization 0.0 and sort behind every real device in the fullest-first
  order (the index breaks the tie), and the per-lane ``n_real`` and
  ``k_eff`` keep the variance test and the source walk blind to them;
* stacks the padded carries on a new leading lane axis, the bucket that
  one step of :class:`repro_torch.fleet.planner._FleetChunk` plans.

While a fleet tick runs, the stacked tensors are the carry;
:meth:`FleetPack.crop_lane` hands a lane back to its
:class:`~repro_torch.core.equilibrium_batch.BatchPlanner` afterwards.
Every axis is cropped to its natural extent **except** the row axis: the
step shifts rows across the whole padded row axis, so the planner adopts
the bucket's width (a power of two, so still a ``row_block`` multiple).

When a lane outgrows its row axis, only its slice moves to the next
bucket (:meth:`FleetPack.rebucket`): the old lane is marked free and no
other lane's tensors change, certificates included.

Lane writes and crops are slice assignments on the device: no host
sync.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from ..core import legality

__all__ = ["CarryDims", "BucketShape", "FleetPack", "pad_const", "pad_dyn",
           "crop_dyn"]

I64 = torch.int64


def _pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class CarryDims:
    """Natural (unpadded) shape of one cluster's batch-engine carry."""

    n_dev: int
    r_cap: int
    n_sh: int
    n_pg: int
    n_slots: int
    n_pools: int
    n_levels: int
    k: int          # the cluster's true source-queue depth

    @classmethod
    def of(cls, bp) -> "CarryDims":
        """Read the dims off a synced BatchPlanner (``bp._step`` set)."""
        step = bp._step
        dyn, const = step.dyn, step.const
        return cls(n_dev=int(const["cap"].shape[0]),
                   r_cap=int(dyn["rows_on"].shape[1]),
                   n_sh=int(const["sh_size"].shape[0]),
                   n_pg=int(dyn["acting"].shape[0]),
                   n_slots=int(dyn["acting"].shape[1]),
                   n_pools=int(const["ideal"].shape[0]),
                   n_levels=int(const["dev_domain"].shape[0]),
                   k=int(step.k))


@dataclasses.dataclass(frozen=True)
class BucketShape:
    """Padded shape shared by every lane of one bucket; the bucket's
    key."""

    n_dev: int
    r_cap: int
    n_sh: int
    n_pg: int
    n_slots: int
    n_pools: int
    n_levels: int
    k: int          # the step's source-queue width (>= every lane's k_eff)

    @classmethod
    def for_dims(cls, dims: CarryDims, rb: int) -> "BucketShape":
        # rb is a power of two (FleetPack checks), so any power-of-two
        # r_cap >= rb stays a multiple of rb
        n_dev = _pow2(dims.n_dev)
        return cls(n_dev=n_dev, r_cap=max(rb, _pow2(dims.r_cap)),
                   n_sh=_pow2(dims.n_sh), n_pg=_pow2(dims.n_pg),
                   n_slots=_pow2(dims.n_slots),
                   n_pools=_pow2(dims.n_pools),
                   n_levels=_pow2(dims.n_levels),
                   k=min(n_dev, _pow2(dims.k)))

    def next_r_cap(self) -> "BucketShape":
        return dataclasses.replace(self, r_cap=self.r_cap * 2)

    def fits(self, dims: CarryDims) -> bool:
        return (dims.n_dev <= self.n_dev and dims.r_cap <= self.r_cap
                and dims.n_sh <= self.n_sh and dims.n_pg <= self.n_pg
                and dims.n_slots <= self.n_slots
                and dims.n_pools <= self.n_pools
                and dims.n_levels <= self.n_levels and dims.k <= self.k)

    def grown_to(self, dims: CarryDims, rb: int) -> "BucketShape":
        """The smallest bucket covering both this shape and ``dims``, so
        that a lane's earlier row-axis growth stays when another axis
        grows."""
        want = BucketShape.for_dims(dims, rb)
        return BucketShape(*(max(a, b) for a, b in
                             zip(dataclasses.astuple(self),
                                 dataclasses.astuple(want))))


def _pad(t: torch.Tensor, shape: tuple, value) -> torch.Tensor:
    """``t`` in the top corner of a ``shape`` tensor filled with
    ``value``."""
    out = torch.full(shape, value, dtype=t.dtype, device=t.device)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def pad_const(const: dict, shape: BucketShape) -> dict:
    """One cluster's ``const`` padded to the bucket shape.  Pad devices:
    capacity 1.0 (divisions stay finite), class -2 (matches no shard
    class), ``in`` False (never a destination), domain -2 at every level
    (shared with no real device).  Pad shard rows: size 0.0, which no
    real row has, and class -1."""
    n, s, p, lv = shape.n_dev, shape.n_sh, shape.n_pools, shape.n_levels
    out = {"cap": _pad(const["cap"], (n,), 1.0),
           "dev_class": _pad(const["dev_class"], (n,), -2),
           "dev_in": _pad(const["dev_in"], (n,), False),
           "dev_domain": _pad(const["dev_domain"], (lv, n), -2),
           "sh_class": _pad(const["sh_class"], (s,), -1),
           "ideal": _pad(const["ideal"], (p, n), 0.0)}
    for key in ("sh_size", "sh_pg", "sh_pool", "sh_level", "sh_slot",
                "sh_sbase", "sh_scnt"):
        out[key] = _pad(const[key], (s,), 0)
    return out


def pad_dyn(dyn: dict, shape: BucketShape) -> dict:
    """One cluster's ``dyn`` padded to the bucket shape.  Pad devices
    enter the fullest-first order *behind* every real device
    (utilization 0.0, and their indices above every real one break the
    tie the same way the step's re-sort does), their row lists are
    empty (-1), their ``dst_ok`` columns False, and they are never
    pruned: ``order[:n_real]`` always holds exactly the real devices, so
    the crop back to natural shape is a slice.  Pad PGs' acting slots
    are -1; ``us`` and ``usq`` are the cluster's own."""
    n, n_nat = shape.n_dev, dyn["used"].shape[0]
    p, g = shape.n_pools, shape.n_pg
    order = dyn["order"]
    return {
        "used": _pad(dyn["used"], (n,), 0.0),
        "util": _pad(dyn["util"], (n,), 0.0),
        "us": dyn["us"].clone(), "usq": dyn["usq"].clone(),
        "acting": _pad(dyn["acting"], (g, shape.n_slots), -1),
        "pool_counts": _pad(dyn["pool_counts"], (p, n), 0.0),
        "dst_ok": _pad(dyn["dst_ok"], (p, n), False),
        "rows_on": _pad(dyn["rows_on"], (n, shape.r_cap), -1),
        "nrows": _pad(dyn["nrows"], (n,), 0),
        "order": torch.cat([order, torch.arange(n_nat, n, dtype=order.dtype,
                                                device=order.device)]),
        "pruned": _pad(dyn["pruned"], (n,), False),
    }


def crop_dyn(dyn: dict, dims: CarryDims) -> dict:
    """A planned lane cropped to its natural shape on every axis but the
    row axis (rows shift across the whole padded width; the planner
    adopts the bucket's), as new tensors."""
    n = dims.n_dev
    return {"used": dyn["used"][:n].clone(), "util": dyn["util"][:n].clone(),
            "us": dyn["us"].clone(), "usq": dyn["usq"].clone(),
            "acting": dyn["acting"][:dims.n_pg, :dims.n_slots].clone(),
            "pool_counts": dyn["pool_counts"][:dims.n_pools, :n].clone(),
            "dst_ok": dyn["dst_ok"][:dims.n_pools, :n].clone(),
            "rows_on": dyn["rows_on"][:n].clone(),
            "nrows": dyn["nrows"][:n].clone(),
            "order": dyn["order"][:n].clone(),
            "pruned": dyn["pruned"][:n].clone()}


#: the per-lane scalars of a bucket: the three criteria's, and n_real
#: (the variance test's n) and k_eff (the cluster's source-queue depth)
SCALARS = ("slack", "headroom", "min_dvar", "n_f", "k_eff")


def _scalars_of(bp, dims: CarryDims) -> dict:
    """One lane's scalars, each a 1-element device tensor: the planner's
    own (from its config, as its build made them) and k_eff, filled on
    the device (no host-to-device copy)."""
    scal = bp._step.scal
    return {**{key: scal[key].reshape(1) for key in SCALARS[:4]},
            "k_eff": torch.full((1,), dims.k, dtype=I64,
                                device=scal["n_f"].device)}


def _slice(d: dict, i: int) -> dict:
    return {key: t[i] for key, t in d.items()}


class _Bucket:
    """One shape's lanes: stacked carries plus per-lane bookkeeping.

    ``keys[i] is None`` marks lane ``i`` free: its stacked values are
    stale and inert (the planner never sets such a lane active, and an
    inactive lane's step changes nothing).  Freed lanes are reused by the
    next :meth:`put` before the tensors grow."""

    def __init__(self, shape: BucketShape):
        self.shape = shape
        self.keys: list[object | None] = []
        self.dims: list[CarryDims | None] = []
        self.dyn: dict | None = None        # leading axis: the lanes
        self.const: dict | None = None
        self.scal: dict | None = None       # SCALARS, (lanes,) each
        #: the step bound to the stacked tensors (planner's, made at
        #: dispatch; dropped whenever a lane is written)
        self.step = None
        self._mask_cache: dict[bytes, torch.Tensor] = {}

    def __len__(self) -> int:
        return len(self.keys)

    def lanes(self) -> dict[object, int]:
        return {k: i for i, k in enumerate(self.keys) if k is not None}

    def put(self, key, dyn: dict, const: dict, scal: dict,
            dims: CarryDims) -> int:
        """Insert or overwrite one lane from an unpadded carry (padding
        happens here; an already padded one passes through); returns the
        lane index.  Only that lane's values change."""
        dyn_p, const_p = pad_dyn(dyn, self.shape), pad_const(const, self.shape)
        self.step = None
        if key in self.keys:
            i = self.keys.index(key)
        elif None in self.keys:
            i = self.keys.index(None)
        else:
            self.keys.append(key)
            self.dims.append(dims)
            for name, d in (("dyn", dyn_p), ("const", const_p),
                            ("scal", scal)):
                held = getattr(self, name)
                # a scalar's lane entry is one element, a tensor's its shape
                one = {k: v.reshape(1) if name == "scal" else v[None]
                       for k, v in d.items()}
                setattr(self, name, {
                    k: v.clone() if held is None else torch.cat([held[k], v])
                    for k, v in one.items()})
            self._mask_cache.clear()
            return len(self.keys) - 1
        self.keys[i] = key
        self.dims[i] = dims
        for held, d in ((self.dyn, dyn_p), (self.const, const_p),
                        (self.scal, scal)):
            for k, v in d.items():
                held[k][i] = v.reshape(held[k].shape[1:])
        return i

    def dispatch_mask(self, mask) -> torch.Tensor:
        """Device copy of one bool lane mask (numpy), kept by value: the
        live set repeats across rounds far more often than it changes."""
        key = mask.tobytes()
        dev = self._mask_cache.get(key)
        if dev is None:
            if len(self._mask_cache) > 64:       # stale live sets
                self._mask_cache.clear()
            dev = self._mask_cache[key] = torch.as_tensor(
                mask, device=self.dyn["used"].device)
        return dev

    def free(self, i: int) -> None:
        self.keys[i] = None
        self.dims[i] = None

    def slice_dyn(self, i: int) -> dict:
        return _slice(self.dyn, i)

    def slice_const(self, i: int) -> dict:
        return _slice(self.const, i)

    def slice_scal(self, i: int) -> dict:
        return {k: t[i:i + 1] for k, t in self.scal.items()}


class FleetPack:
    """The fleet's buckets of stacked carries, where each cluster's lane
    is, and which planner carry each lane was packed from (so that an
    unchanged cluster's lane is reused as it is across ticks)."""

    def __init__(self, rb: int = 8):
        if rb < 1 or rb & (rb - 1):
            raise ValueError(f"row_block must be a power of two, got {rb}")
        self.rb = rb
        self.buckets: dict[BucketShape, _Bucket] = {}
        self.where: dict[object, tuple[BucketShape, int]] = {}
        # the planner's carry (bp._step) the lane holds, weakly: while it
        # is still the planner's, the stacked lane is the authoritative
        # carry
        self.tokens: dict[object, weakref.ref] = {}

    # -- packing --------------------------------------------------------------

    def _insert(self, key, bp, dims: CarryDims, shape: BucketShape) -> None:
        bucket = self.buckets.get(shape)
        if bucket is None:
            bucket = self.buckets[shape] = _Bucket(shape)
        step = bp._step
        i = bucket.put(key, step.dyn, step.const, _scalars_of(bp, dims), dims)
        self.where[key] = (shape, i)
        self.tokens[key] = weakref.ref(step)

    def current(self, key, bp) -> bool:
        """Whether ``key``'s lane holds ``bp``'s carry as it stands."""
        tok = self.tokens.get(key)
        return (tok is not None and bp._step is not None
                and tok() is bp._step)

    def ensure(self, key, bp) -> bool:
        """Make ``key``'s lane current with ``bp``'s carry; True when the
        lane had to be (re)packed, False when the stacked lane was still
        authoritative (nothing moved, nothing copied)."""
        dims = CarryDims.of(bp)
        loc = self.where.get(key)
        if loc is not None:
            shape, i = loc
            if self.current(key, bp) and shape.fits(dims):
                return False
            if shape.fits(dims):        # same bucket, refreshed carry
                self._insert(key, bp, dims, shape)
                return True
            # outgrew the bucket: free the old lane, move this one only
            self.buckets[shape].free(i)
            del self.where[key]
            self._insert(key, bp, dims, shape.grown_to(dims, self.rb))
            return True
        self._insert(key, bp, dims, BucketShape.for_dims(dims, self.rb))
        return True

    def remove(self, key) -> None:
        loc = self.where.pop(key, None)
        self.tokens.pop(key, None)
        if loc is not None:
            shape, i = loc
            self.buckets[shape].free(i)

    # -- mid-plan re-bucketing ------------------------------------------------

    def rebucket(self, key) -> tuple[BucketShape, int]:
        """Move one lane that outgrew its row axis to the bucket with
        twice the rows, carrying its current device values along: the row
        axis is extended with -1 (what the serial engine's re-pad writes,
        since every entry past ``nrows`` already is -1) and every other
        axis is unchanged.  The old lane is freed; no other lane changes.
        Returns the new (bucket shape, lane index)."""
        shape, i = self.where[key]
        old = self.buckets[shape]
        dyn, const = old.slice_dyn(i), old.slice_const(i)
        scal, dims = old.slice_scal(i), old.dims[i]
        old.free(i)
        new_shape = shape.next_r_cap()
        rows = dyn["rows_on"]
        dyn = {**dyn, "rows_on": _pad(rows, (rows.shape[0], new_shape.r_cap),
                                      -1)}
        bucket = self.buckets.get(new_shape)
        if bucket is None:
            bucket = self.buckets[new_shape] = _Bucket(new_shape)
        j = bucket.put(key, dyn, const, scal, dims)
        self.where[key] = (new_shape, j)
        # the carry moved buckets; the planner's carry is stale until the
        # next crop writes it back
        self.tokens.pop(key, None)
        return new_shape, j

    # -- unpacking ------------------------------------------------------------

    def crop_lane(self, key, bp) -> None:
        """Write ``key``'s (possibly planned-on) lane back into its
        planner's carry: natural-shape crops of every axis but the row
        axis, whose bucket width the carry adopts.  The carry's K1
        binding follows its replaced tensors, as after a re-pad."""
        shape, i = self.where[key]
        bucket = self.buckets[shape]
        step = bp._step
        step.dyn.update(crop_dyn(bucket.slice_dyn(i), bucket.dims[i]))
        self.tokens[key] = weakref.ref(step)


def capacity_limits(bucket: _Bucket) -> torch.Tensor:
    """(lanes, n) capacity under each lane's headroom, by the legality
    core's expression (what each lane's serial step computes)."""
    return legality.capacity_limit(bucket.const["cap"],
                                   bucket.scal["headroom"][:, None])
