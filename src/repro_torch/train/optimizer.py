"""AdamW with decoupled weight decay and grad-norm clipping (the
counterpart of ``src/repro/train/optimizer.py``).

The state mirrors the parameters leaf for leaf: ``mu`` and ``nu`` are
float32 dicts keyed by the port's parameter names
(``layers.3.ssm.in_z``), ``count`` an int32 scalar tensor.  The
reference decays a leaf when its ``ndim >= 2`` on its own tree, where
the per-layer leaves are stacked, so every per-layer 1-D leaf (``ln``,
``A_log``, ``q_norm``, …) is decayed and ``final_norm`` and the hybrid's
shared-block norms are not; the rule is taken on that shape here too
(:func:`repro_torch.models.convert.reference_ndim`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.convert import reference_ndim


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio · lr``, in float32
    (``step`` an int or a tensor; the result on its device)."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict[str, torch.Tensor]) -> dict:
    """Zero float32 moments beside each parameter, and ``count`` 0."""
    device = next(iter(params.values())).device
    return {"mu": {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()},
            "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    return torch.sqrt(torch.stack([g.float().square().sum()
                                   for g in tree.values()]).sum())


def adamw_update(cfg: AdamWConfig, grads: dict[str, torch.Tensor],
                 opt_state: dict, params: dict[str, torch.Tensor]
                 ) -> tuple[dict, dict, dict]:
    """One AdamW step → (params, opt_state, metrics ``grad_norm``,
    ``lr``), the reference's arithmetic leaf by leaf.  Unlike the
    reference, which returns new trees, it writes the parameters and the
    moments in place, one leaf at a time, so that a step holds one
    leaf's temporaries at most; ``opt_state["count"]`` is replaced."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, count)
    bias1 = 1 - cfg.b1 ** count.float()
    bias2 = 1 - cfg.b2 ** count.float()
    with torch.no_grad():
        for name, g in grads.items():
            p, mu, nu = params[name], opt_state["mu"][name], \
                opt_state["nu"][name]
            g = g.float() * scale
            mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
            nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g * g)
            step = (mu / bias1) / (torch.sqrt(nu / bias2) + cfg.eps)
            # decoupled weight decay on the reference's matrices only
            wd = cfg.weight_decay if reference_ndim(name, p) >= 2 else 0.0
            pf = p.float()
            p.copy_((pf - lr * (step + wd * pf)).to(p.dtype))
    opt_state["count"] = count
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
