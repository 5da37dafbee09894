"""Carry the reference's parameters into the port.

The reference keeps parameters as a nested dict with the layers stacked
on axis 0 (its scan layout); :func:`params_from_numpy` takes that tree as
NumPy arrays and returns an :class:`~repro_torch.models.lm.LM` holding
the same values, layer ``i`` from row ``i`` of each stacked leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .common import ModelConfig
from .lm import LM


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update(_flatten(node, f"{prefix}{name}/"))
        else:
            out[f"{prefix}{name}"] = np.asarray(node)
    return out


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> LM:
    """An :class:`LM` for ``cfg`` on ``device`` (the card unless named)
    holding the parameters of ``tree``.  Raises if a leaf is missing, is
    left over, or has the wrong shape."""
    model = LM(cfg, resolve_device(device, "the LM"))
    leaves = _flatten(tree)
    used = set()
    with torch.no_grad():
        for dotted, param in model.named_parameters():
            parts = dotted.split(".")
            if parts[0] == "layers":             # layers.<i>.<path...>
                key, row = "/".join(["layers", *parts[2:]]), int(parts[1])
            else:
                key, row = "/".join(parts), None
            if key not in leaves:
                raise KeyError(f"parameter tree has no leaf {key!r}")
            value = leaves[key] if row is None else leaves[key][row]
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{key}: shape {value.shape}, the port "
                                 f"expects {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(value, np.float32)))
            used.add(key)
    extra = sorted(set(leaves) - used)
    if extra:
        raise ValueError(f"parameter tree leaves the port does not hold: "
                         f"{extra}")
    stacked = {k: v.shape[0] for k, v in leaves.items()
               if k.startswith("layers/")}
    if any(n != cfg.n_layers for n in stacked.values()):
        raise ValueError(f"stacked layer leaves {stacked} do not have "
                         f"{cfg.n_layers} rows")
    return model
