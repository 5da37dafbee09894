"""End-to-end training driver: data pipeline → train step → checkpoints
(the counterpart of ``src/repro/launch/train.py``: the same flags,
defaults and printed lines, plus ``--device``).

Runs a registry arch (``--reduced``, the default, or ``--full``) on the
card unless ``--device`` names another, from random weights of seed 0.
Atomic checkpoints every ``--save-every`` steps under
``--checkpoint-dir``/<arch>; a restart resumes from the latest manifest,
the data loader's cursor included.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3

As in the reference, a restart whose latest checkpoint is at or past
``--steps`` runs no step and then fails at its final print, where the
last step's metrics are unbound.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import DataShard, SyntheticTokenSource, TokenLoader
from repro_torch.models.convert import tree_from_numpy, tree_to_numpy
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def state_to_numpy(state: dict) -> dict:
    """The train state as the reference's NumPy tree (layers stacked)."""
    opt = state["opt"]
    return {"params": tree_to_numpy(dict(state["params"].named_parameters())),
            "opt": {"mu": tree_to_numpy(opt["mu"]),
                    "nu": tree_to_numpy(opt["nu"]),
                    "count": opt["count"].cpu().numpy()},
            "step": state["step"].cpu().numpy()}


def load_state(state: dict, restored: dict) -> dict:
    """Write a restored NumPy tree (:func:`state_to_numpy`'s layout) into
    ``state`` on its device."""
    model = state["params"]
    device = model.embed.device
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, value in tree_from_numpy(model,
                                           restored["params"]).items():
            params[name].copy_(value)
    for moment in ("mu", "nu"):
        state["opt"][moment] = {
            name: value.to(device)
            for name, value in tree_from_numpy(
                model, restored["opt"][moment]).items()}
    state["opt"]["count"] = torch.as_tensor(restored["opt"]["count"],
                                            dtype=torch.int32).to(device)
    state["step"] = torch.as_tensor(restored["step"],
                                    dtype=torch.int32).to(device)
    return state


def main(argv=None, *, on_step=None, on_restore=None) -> dict:
    """The CLI; returns the final train state.  ``on_step(step, state,
    metrics)`` is called after each step and ``on_restore(state,
    manifest)`` after a resume, for a caller in the same process that
    observes the run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--checkpoint-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_ckpt"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "card; raises without one)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(train_microbatches=args.microbatches)
    if cfg.input_mode != "tokens" or cfg.is_enc_dec:
        raise SystemExit(f"{args.arch}: this driver feeds token batches; "
                         "use the dry-run for frontend-stub archs")

    state = init_train_state(cfg, seed=0, device=args.device)
    device = state["params"].embed.device
    step_fn = make_train_step(cfg, TrainConfig(microbatches=args.microbatches))

    shards = [DataShard(i, args.batch * (args.seq + 1) * 64, seed=1)
              for i in range(4)]
    source = SyntheticTokenSource(shards, cfg.vocab_size, args.seq)
    loader = TokenLoader(source, [s.id for s in shards], args.batch)

    ckpt_dir = Path(args.checkpoint_dir) / args.arch
    start = latest_step(ckpt_dir)
    if start is not None:
        restored, manifest = restore_checkpoint(ckpt_dir)
        state = load_state(state, restored)
        loader.load_state_dict(manifest["meta"]["loader"])
        print(f"[train] resumed from step {start}")
        if on_restore is not None:
            on_restore(state, manifest)

    it = iter(loader)
    t0 = time.time()
    for i in range(int(state["step"]), args.steps):
        batch = {k: torch.from_numpy(v).to(device, torch.int64)
                 for k, v in next(it).items()}
        state, metrics = step_fn(state, batch)
        if on_step is not None:
            on_step(i + 1, state, metrics)
        if (i + 1) % 10 == 0 or i == 0:
            print(f"[train] step {i + 1:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time() - t0) / (i + 1 - int(0)):.2f}s/step)")
        if (i + 1) % args.save_every == 0:
            save_checkpoint(ckpt_dir, i + 1, state_to_numpy(state),
                            extra_meta={"loader": loader.state_dict()})
            print(f"[train] checkpoint @ step {i + 1}")
    loader.close()
    print(f"[train] done: {args.steps} steps, final loss "
          f"{float(metrics['loss']):.4f}")
    return state


if __name__ == "__main__":
    main()
