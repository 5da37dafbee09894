#!/usr/bin/env python3
"""Does the Python heap of ``chip_smoke.py``'s earlier phases slow its
serving run?  Runs (c) of phase ``serve`` (``chip_smoke.serve_zamba2``:
the 81-layer zamba2-7b ``ServeEngine``, 8 requests of 32 tokens) three
times in one process: fresh, with cluster B built and held (as the
earlier phases hold it), and then with the heap frozen
(``gc.freeze()``); prints one JSON line a run with the decode-step
milliseconds and the seconds the garbage collector took.

    PYTHONPATH=src python3 tools/serve_heap_check.py    # from the repo root, on a card

Needs one CUDA card (27 GB of weights) and builds the kernels first
(``chip_smoke.phase_env``); about 2.5 minutes on an H100.
"""

import gc
import json
import sys
import time

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

sys.path.insert(0, str(cs.SRC))

spent = {"s": 0.0, "n": 0, "gen2": 0}
_start = [0.0]


def _timed_gc(phase, info):
    if phase == "start":
        _start[0] = time.perf_counter()
    else:
        spent["s"] += time.perf_counter() - _start[0]
        spent["n"] += 1
        spent["gen2"] += info["generation"] == 2


def run(card: str, label: str) -> None:
    spent.update(s=0.0, n=0, gen2=0)
    out = cs.serve_zamba2(card)
    print(json.dumps({"label": label, "card": card, "run_s": out["run_s"],
                      "decode_step_ms": out["decode_step_ms"],
                      "gc_s": spent["s"], "gc_runs": spent["n"],
                      "gc_gen2": spent["gen2"],
                      "tracked_objects": len(gc.get_objects())}), flush=True)


def main() -> None:
    sys.argv = ["chip_smoke.py"]
    gc.callbacks.append(_timed_gc)
    card = cs.phase_env()["card"]
    run(card, "fresh")
    t0 = time.perf_counter()
    built_b = cs.build_cluster_b()
    print("cluster b built", time.perf_counter() - t0, flush=True)
    run(card, "cluster B held")
    gc.freeze()
    run(card, "cluster B held, heap frozen")
    del built_b


if __name__ == "__main__":
    main()
