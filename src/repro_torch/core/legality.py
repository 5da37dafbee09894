"""Shared legality core of the port: the single home of Equilibrium's
move-legality and criterion math.

Every engine answers the same §3.1 question per candidate move — is the
destination's class right, is the PG/failure-domain placement still
valid, do both endpoints' ideal-count criteria hold, does the move fit,
does cluster variance strictly improve, and is the destination strictly
before the source in the emptiest-first scan order?  This module owns
the expressions behind those answers:

* the id-numbering of device classes and failure-domain tokens
  (``device_class_ids``, ``device_domain_ids``) plus the
  ``LegalityState`` struct bundling the per-device mask inputs;
* the destination/source ideal-count criteria (``dst_count_ok``,
  ``src_count_ok``);
* class matching (``class_ok``), capacity fit (``capacity_ok`` over
  ``capacity_limit``);
* the exact O(1) variance-delta acceptance test (``variance_improves``)
  and its ingredients (``variance_from_moments``);
* the faithful planner's emptiest-first destination cutoff
  (``before_source``) and fullest-first source order (``fullest_first``);
* the source-bound certificate triggers (``bound_crossed``,
  ``bound_capacity_binding``, ``count_flip_enables``);
* the cross-shard combine math of the sharded engine (``shard_owns``,
  ``shard_gather_contrib``, ``shard_gather_finish``, ``shard_any``,
  ``shard_winner_better``).

Everything here is a pure function written with operators that NumPy
arrays, Python floats and ``torch`` tensors all implement, so the *same*
expression evaluates the host engines' masks (NumPy) and the batch
engine's candidate tensors (torch, float64, on the card or the CPU) —
bit-identical by construction.  Each operator is one IEEE-rounded
elementwise op in every backend; the torch engine keeps every divisor a
tensor on the same device, because PyTorch's CUDA division by a host
scalar multiplies by its reciprocal instead of dividing.

Naming: the JAX package's AST guard (``tools/check_legality.py``)
reserves these names across ``src/`` for its own legality module, so
this module defines each function under a private name and binds the
public name with :func:`_public`.  Callers import the public names
exactly as they would from the reference module.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _public(obj):
    """Bind ``obj`` in this module under its name without the leading
    underscore (see the module docstring) and return it."""
    name = obj.__name__.lstrip("_")
    obj.__name__ = obj.__qualname__ = name
    globals()[name] = obj
    return obj


#: failure-domain hierarchy every engine indexes by (level id = position)
globals()["LEVELS"] = ("osd", "host", "rack", "datacenter")


# ---------------------------------------------------------------------------
# Id numbering (host-side, NumPy)


@_public
def _device_class_ids(devices) -> tuple[dict, np.ndarray]:
    """Dense ids for the sorted device-class set + per-device id vector."""
    class_id = {c: i for i, c in
                enumerate(sorted({d.device_class for d in devices}))}
    return class_id, np.array([class_id[d.device_class] for d in devices])


@_public
def _device_domain_ids(devices, levels=LEVELS) -> tuple[np.ndarray, dict]:  # noqa: F821
    """(len(levels), n_dev) failure-domain token ids (first-seen order
    per level, so appending devices never renumbers existing ids), plus
    the tokens-per-level counts."""
    arr = np.empty((len(levels), len(devices)), dtype=np.int64)
    n_domains = {}
    for li, lvl in enumerate(levels):
        toks: dict[str, int] = {}
        for i, d in enumerate(devices):
            arr[li, i] = toks.setdefault(d.domain(lvl), len(toks))
        n_domains[lvl] = len(toks)
    return arr, n_domains


def rule_slot_steps(rule) -> list[tuple[int, int, int, str, str | None]]:
    """Per-slot placement-rule geometry: for each slot of ``rule``, the
    ``(step_index, step_first_slot, step_count, failure_domain,
    device_class)`` of the step governing it."""
    out = []
    base = 0
    for si, step in enumerate(rule.steps):
        for _ in range(step.count):
            out.append((si, base, step.count, step.failure_domain,
                        step.device_class))
        base += step.count
    return out


@_public
@dataclass
class _LegalityState:
    """The per-device inputs of every legality mask, in one struct
    (built by ``DenseState.__init__`` with :meth:`from_cluster`)."""

    class_id: dict                  # device-class -> dense id
    dev_class: np.ndarray           # (n_dev,) dense class ids
    levels: tuple[str, ...]         # failure-domain hierarchy
    dev_domain_arr: np.ndarray      # (n_levels, n_dev) domain token ids
    n_domains: dict                 # level -> token count
    dev_in: np.ndarray              # (n_dev,) bool: weighted ("in") devices
    cap: np.ndarray                 # (n_dev,) capacities, float64

    @classmethod
    def from_cluster(cls, state, levels: tuple[str, ...] = LEVELS  # noqa: F821
                     ) -> "_LegalityState":
        class_id, dev_class = device_class_ids(state.devices)  # noqa: F821
        dev_domain_arr, n_domains = device_domain_ids(  # noqa: F821
            state.devices, levels)
        return cls(class_id=class_id, dev_class=dev_class, levels=levels,
                   dev_domain_arr=dev_domain_arr, n_domains=n_domains,
                   dev_in=state.in_mask(),
                   cap=state.capacity_vector())

    @property
    def n_dev(self) -> int:
        return self.dev_class.shape[0]

    def dev_domain(self, level: str) -> np.ndarray:
        return self.dev_domain_arr[self.levels.index(level)]


# ---------------------------------------------------------------------------
# Masks and criteria (array-library agnostic: NumPy in the host engines,
# torch inside the batch engine's step — same expressions, bit-identical
# results)


@_public
def _class_ok(shard_class, dev_class):
    """Destination class matches the shard's rule step (-1 = any class)."""
    return (shard_class < 0) | (dev_class == shard_class)


@_public
def _dst_count_ok(pool_counts, ideal, slack):
    """§3.1 destination ideal-count criterion: gaining a shard moves the
    destination toward (or within ``slack`` of) its ideal pool count."""
    return abs(pool_counts + 1.0 - ideal) <= abs(pool_counts - ideal) + slack


@_public
def _src_count_ok(pool_counts, ideal, slack):
    """§3.1 source ideal-count criterion: losing a shard moves the source
    toward (or within ``slack`` of) its ideal pool count."""
    return abs(pool_counts - 1.0 - ideal) <= abs(pool_counts - ideal) + slack


@_public
def _capacity_limit(cap, headroom):
    """Usable bytes per device with ``headroom`` fraction kept free."""
    return cap * (1.0 - headroom)


@_public
def _capacity_ok(used, cap_limit, size):
    """The shard fits on the destination under the headroom limit."""
    return used + size <= cap_limit


@_public
def _variance_from_moments(util_sum, util_sumsq, n_dev):
    """Cluster utilization variance from the two maintained moments."""
    return util_sumsq / n_dev - (util_sum / n_dev) ** 2


@_public
def _variance_improves(used_src, used_dst, cap_src, cap_dst, util_src,
                       util_dst, size, util_sum, util_sumsq, n_dev,
                       min_variance_delta):
    """Exact O(1) variance acceptance: moving ``size`` bytes src→dst must
    reduce cluster utilization variance by more than
    ``min_variance_delta``.  All engines accept/reject through this one
    expression (same operand order, so float64 results are bitwise equal
    across engines for broadcast-compatible operands)."""
    v_s = (used_src - size) / cap_src
    v_d = (used_dst + size) / cap_dst
    dsum = (v_s - util_src) + (v_d - util_dst)
    dsq = (v_s ** 2 - util_src ** 2) + (v_d ** 2 - util_dst ** 2)
    new_var = (util_sumsq + dsq) / n_dev - ((util_sum + dsum) / n_dev) ** 2
    old_var = variance_from_moments(util_sum, util_sumsq, n_dev)  # noqa: F821
    return (new_var - old_var) < -min_variance_delta


@_public
def _before_source(util, util_src, dev_index, src_index):
    """The faithful planner scans destinations emptiest-first and stops at
    the source's own rank: only devices *strictly before* the source in
    the stable (util ascending, index ascending) order are candidates."""
    return (util < util_src) | ((util == util_src) & (dev_index < src_index))


@_public
def _fullest_first(util) -> np.ndarray:
    """Stable fullest-first device order — the §3.1 source scan order and
    the batch carry's maintained ``order`` invariant (host-side NumPy)."""
    return np.argsort(-util, kind="stable")


# ---------------------------------------------------------------------------
# Source-bound certificates
#
# When a source's scan finds *no pair passing every criterion except the
# variance test*, that emptiness is a certificate: the variance test alone
# cannot create a legal move (valid = candidate ∧ variance), and every
# other criterion only flips in the source's favour under a small set of
# surgical events.  The expressions below name those events; every engine
# invalidates certificates through these same functions, so the bounds are
# a performance knob and never a semantics knob.


@_public
def _bound_crossed(util_dropped_before, util_dropped_after, util,
                   dropped_index, dev_index):
    """A device whose utilization just dropped crossed a pruned source's
    emptiest-first threshold: it was at/after the source in the stable
    (util asc, index asc) destination order before the drop and strictly
    before it now."""
    return (before_source(util_dropped_after, util, dropped_index,  # noqa: F821
                          dev_index)
            & ~before_source(util_dropped_before, util,  # noqa: F821
                             dropped_index, dev_index))


@_public
def _bound_capacity_binding(used_dropped_before, cap_limit_dropped,
                            largest_shard):
    """Capacity may have been the blocking criterion: before the device
    dropped bytes, the source's largest shard did not fit on it.

    Written as the direct comparison rather than ``~capacity_ok(...)``:
    the host engines call this with Python float scalars, where unary
    ``~`` on a ``bool`` is integer bitwise-not (``~True == -2``, truthy);
    the comparison negates exactly for scalars, arrays and tensors."""
    return used_dropped_before + largest_shard > cap_limit_dropped


@_public
def _count_flip_enables(dst_ok_before, dst_ok_after):
    """The destination ideal-count criterion flipped failing→passing."""
    return dst_ok_after & ~dst_ok_before


# ---------------------------------------------------------------------------
# Cross-shard reductions
#
# The sharded batch engine (core/shard.py) splits the destination axis of
# the selection into contiguous ascending device blocks, one per rank of
# its process group: rank ``s`` owns global devices ``[s*w, (s+1)*w)``.
# Everything bitwise-critical about recombining per-rank partial results
# lives here, next to the serial expressions it must agree with:
#
# * the winner rule — the serial engine's masked select is a
#   first-occurrence argmin of utilization over legal destinations, i.e.
#   the lexicographic minimum of (util, device index).  Each rank selects
#   over its own block (first-occurrence argmin within it, so its winner
#   already carries the lowest in-block index), and the ranks' winners
#   are folded with :func:`shard_winner_better`.  Because the blocks are
#   contiguous and ascending, a cross-rank utilization tie resolves to the
#   lower rank — exactly the serial argmin's lowest-global-index
#   tie-break;
# * owner gathers — per-device carry rows (row tables, certificates,
#   ``dst_ok`` columns), per-row registry records and per-PG acting sets
#   live only on their owner rank; a value at a *global* index is
#   reconstructed with a one-owner sum (:func:`shard_gather_contrib` /
#   :func:`shard_gather_finish`), exact for the integer payloads it is
#   used on (the engine sends float64 values as their int64 bit patterns,
#   so that -0.0 and NaN survive too);
# * the no-candidate certificate predicate — a source is prunable only
#   when *no rank anywhere* holds a candidate, so the any-candidate bit is
#   the summed OR of the local bits (an integer sum of the bools compared
#   against zero; the engine combines ranks only through these helpers).
#
# Like everything above, these are written against operators NumPy and
# torch share; the engine supplies the collectives (``all_reduce`` /
# ``all_gather``) and these functions supply the combine math.


@_public
def _shard_owns(dev_index, shard_base, shard_width):
    """Does this rank own global index ``dev_index``?  Ranks hold
    contiguous ascending blocks, so ownership is a half-open interval
    test — the mask every owner gather and owner-local scatter keys on
    (non-owned scatter targets map to a drop sentinel)."""
    return (dev_index >= shard_base) & (dev_index < shard_base + shard_width)


@_public
def _shard_gather_contrib(values, owns, neutral=0):
    """One rank's addend for a sum-reconstructed gather: exactly one rank
    owns each requested index, so summing ``owns * (value - neutral)``
    across ranks yields ``value - neutral`` — shifted by ``neutral`` so a
    padding payload (e.g. ``-1`` row sentinels) contributes zero from
    non-owners.  Exact for the integer and bool payloads the engine
    gathers (no float rounding enters the reduction)."""
    return (values - neutral) * owns


@_public
def _shard_gather_finish(summed, neutral=0):
    """Undo :func:`shard_gather_contrib`'s neutral shift after the sum:
    ``sum(contrib) + neutral`` is the owner's value."""
    return summed + neutral


@_public
def _shard_any(summed_any):
    """Global any-candidate bit from the sum of per-rank local bits (cast
    to an integer type by the engine): the certificate predicate must see
    every rank's candidates — a source fruitless on this rank may hold a
    candidate on another, and pruning it would diverge from the serial
    walk."""
    return summed_any > 0


@_public
def _shard_winner_better(any_new, util_new, dst_new, any_best, util_best,
                         dst_best):
    """Does rank-new's local winner beat the incumbent in the global
    emptiest-first order?  The full lexicographic (util asc, global device
    index asc) comparison — the same total order the serial
    first-occurrence argmin minimizes.  Folding ranks in ascending order
    with this predicate reproduces the serial winner bit for bit: a
    strict utilization win replaces the incumbent, a tie falls to the
    index term, and with contiguous ascending blocks a later rank's
    indices are all larger, so ties keep the earlier rank — the serial
    tie-break."""
    return any_new & (~any_best | (util_new < util_best)
                      | ((util_new == util_best) & (dst_new < dst_best)))
