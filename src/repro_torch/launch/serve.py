"""Serving launcher: batched continuous decoding with Equilibrium-balanced
paged KV admission, on a reduced config (2 layers, vocab 256) with
random weights from seed 0.  Runs on the card unless ``--device`` names
another.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model
from repro_torch.serve import PagedKVPool, PagedKVSpec, Request, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA "
                         "card; raises without one)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if cfg.is_enc_dec:
        raise SystemExit("enc-dec serving needs encoder features; use the "
                         "dry-run serve cells for seamless")
    cfg = cfg.reduced(n_layers=2, vocab_size=256)
    model = build_model(cfg, seed=0, device=args.device)
    pool = PagedKVPool(PagedKVSpec(n_chips=args.slots, page_tokens=16,
                                   pages_per_chip=256))
    engine = ServeEngine(cfg, model, batch_slots=args.slots, max_len=128,
                         pool=pool)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size,
                              size=int(rng.integers(4, 12)))
        engine.submit(Request(id=i, prompt=prompt,
                              max_new_tokens=args.new_tokens))

    t0 = time.time()
    steps = 0
    while engine.queue or engine.active:
        engine.step()
        steps += 1
        if steps > 10_000:
            raise SystemExit("serving did not converge")
    dt = time.time() - t0
    where = torch.cuda.get_device_name(engine.device) \
        if engine.device.type == "cuda" else engine.device.type.upper()
    total_tokens = args.requests * args.new_tokens
    print(f"[serve] {args.requests} requests × {args.new_tokens} tokens in "
          f"{steps} steps, {dt:.1f}s ({total_tokens / dt:.1f} tok/s on "
          f"{where}); KV migrated: {engine.migrated_bytes / 1e6:.1f} MB; "
          f"final pool util: {pool.utilization().round(3)}")


if __name__ == "__main__":
    main()
