"""Carry parameter trees between the reference's layout and the port's.

The reference keeps parameters as a nested dict with the layers stacked
on axis 0 (its scan layout); the port holds one module per layer, its
parameters named ``layers.<i>.<path>``.  :func:`params_from_numpy` takes
the reference's tree as NumPy arrays and returns an
:class:`~repro_torch.models.lm.LM` holding the same values, layer ``i``
from row ``i`` of each stacked leaf; :func:`params_to_numpy` is its
inverse.  :func:`tree_from_numpy` and :func:`tree_to_numpy` do the same
for any flat dict keyed by the port's parameter names, such as the
optimizer's moments, which mirror the parameters leaf for leaf.
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


def reference_leaf(dotted: str) -> tuple[str, int | None]:
    """The reference tree's leaf path of a port parameter name and its
    row there: ``layers.3.ssm.in_z`` → (``layers/ssm/in_z``, 3), the
    others (``embed``, ``shared.attn.wq``, …) → (their path, None)."""
    parts = dotted.split(".")
    if parts[0] == "layers":
        return "/".join(["layers", *parts[2:]]), int(parts[1])
    return "/".join(parts), None


def reference_ndim(dotted: str, tensor: torch.Tensor) -> int:
    """The number of dimensions the leaf has in the reference's tree: one
    more than the port's for a per-layer leaf, which is stacked there.
    The reference's rules by ``ndim`` (the train step's compute cast,
    AdamW's weight decay) are taken on this."""
    return tensor.dim() + (reference_leaf(dotted)[1] is not None)


def tree_from_numpy(model: LM, tree: dict) -> dict[str, torch.Tensor]:
    """The leaves of ``tree`` (the reference's layout, NumPy) as float32
    CPU tensors keyed by ``model``'s parameter names.  Raises if a leaf is
    missing, is left over, or has the wrong shape, or if a stacked leaf's
    rows are not the model's layers."""
    cfg = model.cfg
    leaves = _flatten(tree)
    used, out = set(), {}
    for dotted, param in model.named_parameters():
        key, row = reference_leaf(dotted)
        if key not in leaves:
            raise KeyError(f"parameter tree has no leaf {key!r}")
        value = leaves[key] if row is None else leaves[key][row]
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{key}: shape {value.shape}, the port "
                             f"expects {tuple(param.shape)}")
        out[dotted] = torch.from_numpy(np.array(value, np.float32))
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
    return out


def tree_to_numpy(tensors: dict[str, torch.Tensor]) -> dict:
    """The reference's nested tree of a flat dict keyed by the port's
    parameter names: per-layer tensors stacked on axis 0 in layer order,
    every leaf a NumPy array of the tensor's dtype (on the host)."""
    rows: dict[str, dict[int, torch.Tensor]] = {}
    flat: dict[str, np.ndarray] = {}
    for dotted, t in tensors.items():
        key, row = reference_leaf(dotted)
        if row is None:
            flat[key] = t.detach().cpu().numpy()
        else:
            rows.setdefault(key, {})[row] = t.detach()
    for key, by_row in rows.items():
        flat[key] = torch.stack([by_row[i] for i in range(len(by_row))]
                                ).cpu().numpy()
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> LM:
    """An :class:`LM` for ``cfg`` on ``device`` (the card unless named)
    holding the parameters of ``tree`` (:func:`tree_from_numpy`'s checks)."""
    model = LM(cfg, resolve_device(device, "the LM"))
    values = tree_from_numpy(model, tree)
    with torch.no_grad():
        for dotted, param in model.named_parameters():
            param.copy_(values[dotted])
    return model


def params_to_numpy(model: LM) -> dict:
    """The reference's parameter tree (NumPy, float32, layers stacked on
    axis 0) of ``model``: :func:`params_from_numpy`'s inverse."""
    return tree_to_numpy(dict(model.named_parameters()))
