"""Differential lifecycle fuzzing CLI (see :mod:`repro_torch.fuzz`).

Modes:

* **sweep** (default): generate one timeline per seed in ``--seeds A:B``
  and run each through every engine lane under the full oracle set.  On
  the first oracle failure, optionally shrink (``--shrink``) and save
  the minimized reproducer to the corpus (``--save``), then exit 1.
* **replay** (``--replay FILE``): run one serialized timeline (corpus
  file) through the full harness and exit by its verdict.
* **mutation smoke** (``--mutate NAME``): patch one legality predicate
  to its vacuous form (``repro_torch.fuzz.mutate.MUTATIONS``), sweep
  seeds until an oracle catches the broken planner, shrink the
  reproducer, and exit 0 only if it was caught *and* shrank to at most
  ``--expect-max-events`` events — the proof the harness would catch a
  real regression of the same shape.  With ``--engines class`` it runs
  the host lanes.  The card's ``select_rows`` compiles the predicates
  into the kernel, where no mutation reaches, so ``--mutate`` with the
  ``equilibrium_batch`` lane on a CUDA device is refused.

``--device`` places the lanes that run on a device
(``equilibrium_batch``, ``equilibrium_jax_legacy``): the CUDA card by
default, which they need; ``--device cpu`` runs them on their kernels'
plain versions.  The sharded-mesh subprocess lane of the JAX package's
CLI (``--shard-subprocess``) waits for the port's sharded engine.

Examples::

    python -m repro_torch.fuzz --seeds 0:32
    python -m repro_torch.fuzz --seeds 0:8 --profile nightly
    python -m repro_torch.fuzz --device cpu --seeds 0:10
    python -m repro_torch.fuzz --replay tests/regressions/legacy-slack-divergence.json
    python -m repro_torch.fuzz --mutate variance_always_improves --shrink --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

HOST_ENGINES = ("equilibrium", "equilibrium_faithful")

#: the lane whose selection runs in ``select_rows`` on a CUDA device,
#: out of reach of a legality mutation
KERNEL_LANE = "equilibrium_batch"


def parse_seeds(spec: str) -> range:
    lo, _, hi = spec.partition(":")
    return range(int(lo or 0), int(hi))


def resolve_engines(spec: str):
    from ..core.planner import planners_in_class
    if spec == "class":
        return planners_in_class("equilibrium")
    if spec == "host":
        return HOST_ENGINES
    return tuple(spec.split(","))


def check_mutation_lanes(engines, device) -> None:
    """Refuse a mutation run whose lanes include the batch engine on a
    CUDA device (``None`` is the card): ``select_rows`` evaluates every
    criterion inside the kernel, so the mutation would not reach it and
    the run would report a healthy kernel as an ``agreement`` failure."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and KERNEL_LANE in engines:
        raise ValueError(
            f"--mutate cannot run the {KERNEL_LANE} lane on {dev}: its "
            f"selection kernel select_rows compiles every legality "
            f"criterion into the kernel, where a mutation of "
            f"repro_torch.core.legality does not reach, so the lane would "
            f"plan healthily and the run would report the kernel as an "
            f"agreement failure; use --engines class or host, or "
            f"--device cpu")


def run_one(tl, engines, device, baselines=True):
    """Full oracle pass on one timeline; returns the reference lane."""
    from . import run_timeline
    from .harness import BASELINE_LANES
    lanes = run_timeline(tl, engines=engines,
                         baseline_lanes=BASELINE_LANES if baselines else (),
                         device=device)
    return lanes[engines[0] if engines else sorted(lanes)[0]]


def make_predicate(engines, oracle: str, device):
    """Shrink predicate: candidate reproduces iff the same oracle fires
    (other failures — including unrelated crashes on mangled
    candidates — do not count)."""
    from . import OracleFailure
    from ..sim.generate import timeline_from_dict

    def fails(d: dict) -> bool:
        try:
            run_one(timeline_from_dict(d), engines, device, baselines=False)
        except OracleFailure as exc:
            return exc.oracle == oracle
        except Exception:
            return False
        return False
    return fails


def shrink_and_save(d, engines, oracle, args):
    from . import save_timeline, shrink_timeline
    small, evals = shrink_timeline(
        d, make_predicate(engines, oracle, args.device),
        max_evals=args.max_evals)
    n_events = len(small["events"])
    print(f"shrunk to {n_events} events / {small['sim']['ticks']} ticks "
          f"in {evals} evals")
    if args.save:
        path = save_timeline(small, args.save, args.corpus)
        print(f"saved reproducer: {path}")
    return small, n_events


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fuzz", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", default="0:50", help="seed range A:B")
    ap.add_argument("--profile", default="quick",
                    help="FuzzProfile name (quick, nightly)")
    ap.add_argument("--engines", default="class",
                    help="'class' (full equivalence class), 'host' "
                         "(NumPy engines only), or a comma list")
    ap.add_argument("--device", default=None,
                    help="device of the batch and legacy lanes (default: "
                         "the CUDA card; 'cpu' runs their plain versions)")
    ap.add_argument("--no-baselines", action="store_true",
                    help="skip the mgr/none reduced-oracle lanes")
    ap.add_argument("--replay", metavar="FILE",
                    help="replay one serialized timeline and exit")
    ap.add_argument("--shrink", action="store_true",
                    help="shrink the reproducer on failure")
    ap.add_argument("--save", metavar="NAME",
                    help="save the (shrunk) reproducer under this corpus "
                         "name")
    ap.add_argument("--corpus", default=None,
                    help="corpus directory (default tests/regressions)")
    ap.add_argument("--mutate", metavar="NAME",
                    help="mutation smoke: run under a broken legality "
                         "predicate and require the harness to catch it "
                         "(not with the equilibrium_batch lane on CUDA)")
    ap.add_argument("--expect-max-events", type=int, default=12,
                    help="mutation smoke: max events in the shrunk "
                         "reproducer")
    ap.add_argument("--max-evals", type=int, default=300,
                    help="shrinker predicate-evaluation budget")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    from . import OracleFailure, load_timeline, mutated
    from ..sim.generate import generate_timeline

    engines = resolve_engines(args.engines)

    if args.replay:
        tl = load_timeline(args.replay)
        try:
            ref = run_one(tl, engines, args.device,
                          baselines=not args.no_baselines)
        except OracleFailure as exc:
            print(f"REPLAY FAILED {args.replay}: {exc}")
            return 1
        print(f"replay ok: {args.replay} ({len(ref.moves)} moves)")
        return 0

    if args.mutate:
        if args.engines == "class":
            engines = HOST_ENGINES    # the card's kernel keeps its criteria
        check_mutation_lanes(engines, args.device)
        with mutated(args.mutate):
            found = None
            for seed in parse_seeds(args.seeds):
                tl = generate_timeline(seed, args.profile)
                try:
                    run_one(tl, engines, args.device, baselines=False)
                except OracleFailure as exc:
                    found = (seed, tl, exc)
                    break
            if found is None:
                print(f"mutation {args.mutate!r} NOT caught in seeds "
                      f"{args.seeds} — the harness is blind to it")
                return 1
            seed, tl, exc = found
            print(f"mutation {args.mutate!r} caught at seed {seed}: {exc}")
            d = tl.to_dict()
            d["provenance"]["mutation"] = args.mutate
            d["provenance"]["oracle"] = exc.oracle
            small, n_events = shrink_and_save(d, engines, exc.oracle, args)
            if n_events > args.expect_max_events:
                print(f"shrunk reproducer still has {n_events} events "
                      f"(> {args.expect_max_events})")
                return 1
        return 0

    t0 = time.time()
    seeds = parse_seeds(args.seeds)
    for i, seed in enumerate(seeds):
        tl = generate_timeline(seed, args.profile)
        try:
            run_one(tl, engines, args.device,
                    baselines=not args.no_baselines)
        except OracleFailure as exc:
            print(f"seed {seed}: {exc}")
            d = tl.to_dict()
            d["provenance"]["oracle"] = exc.oracle
            if args.shrink:
                if not args.save:
                    args.save = f"{exc.oracle}-seed{seed}"
                shrink_and_save(d, engines, exc.oracle, args)
            return 1
        if (i + 1) % 10 == 0 or i + 1 == len(seeds):
            rate = (i + 1) / max(time.time() - t0, 1e-9)
            print(f"[{i + 1}/{len(seeds)}] ok "
                  f"({rate:.2f} timelines/s)", flush=True)
    print(f"sweep ok: {len(seeds)} timelines x {len(engines)} engines, "
          f"0 oracle failures in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
