"""Intentionally-broken legality predicates (mutation smoke).

The fuzz harness is only trustworthy if it *catches* a broken planner.
Each mutation here patches one predicate in
:mod:`repro_torch.core.legality` to a vacuous always-true form; every
engine of the port calls the predicates as module attributes
(``legality.X(...)``), so the patch reaches, at call time, the faithful
and dense host engines, the legacy lane's PyTorch mask (on the CPU or
the card), and the batch engine on the CPU, whose selection is the plain
version ``kernels.ref.select_rows_masks``.  The independent oracles in
:mod:`repro_torch.fuzz.harness` (:meth:`ClusterState.move_is_legal`
replay, monotone-variance recompute) share no code with the patched
module, so a mutation that changes planner behaviour must trip an
oracle.

**It does not reach the card's selection kernel.**  ``select_rows``
(``csrc/masked_select.cu``) compiles every criterion and the float64
variance test into the kernel, so the batch engine on CUDA keeps its
healthy predicates under any mutation here; a run that held such a lane
to a mutated host lane would report the healthy kernel as an
``agreement`` failure.  The CLI (``python -m repro_torch.fuzz``) refuses
that combination.

``python -m repro_torch.fuzz --mutate <name>`` proves the harness: sweep
seeds under the mutation until an oracle fires, shrink the reproducer,
and fail unless the shrunk timeline is small (at most 12 events by
default).

The patch is an attribute store on the legality module, never a
``def`` or assignment of a legality name (which the legality guards
forbid outside the legality core).
"""

from __future__ import annotations

from contextlib import contextmanager

from ..core import legality as _legality

__all__ = ["MUTATIONS", "mutated"]

#: mutation name -> (legality attribute, vacuous replacement).  The
#: replacements keep the original's broadcast shape (they compute with
#: the same operands) so NumPy arrays and tensors both close.
MUTATIONS: dict[str, tuple[str, object]] = {
    # §3.1 acceptance gone: every candidate "improves" variance.  Caught
    # by the monotone-variance replay oracle on nearly any timeline with
    # a rebalance tick.
    "variance_always_improves": (
        "variance_improves",
        lambda used_src, used_dst, cap_src, cap_dst, util_src, util_dst,
               size, util_sum, util_sumsq, n_dev, min_variance_delta:
            (used_dst + size) < float("inf")),
    # capacity ceiling gone: destinations may be planned beyond their
    # usable bytes.  Caught by the move_is_legal replay oracle once a
    # timeline pushes some device near full.
    "capacity_unbounded": (
        "capacity_ok",
        lambda used, cap_limit, size: (used + size) < float("inf")),
    # device-class fencing gone: cross-class destinations become
    # eligible.  Caught by the move_is_legal replay oracle when the
    # planner takes one (requires a mixed-class timeline where an
    # off-class destination also passes the count/variance criteria).
    "class_blind": (
        "class_ok",
        lambda shard_class, dev_class:
            (shard_class < 0) | (dev_class == dev_class)),
}


@contextmanager
def mutated(name: str):
    """Apply one mutation for the duration of the context.

    Restores the original attribute on exit.  The card's ``select_rows``
    keeps its healthy predicates (see the module docstring): mutation
    runs stick to the host lanes, the legacy lane, or the batch engine
    on the CPU.
    """
    attr, fn = MUTATIONS[name]
    original = getattr(_legality, attr)
    setattr(_legality, attr, fn)
    try:
        yield
    finally:
        setattr(_legality, attr, original)
