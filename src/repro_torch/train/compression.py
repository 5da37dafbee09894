"""Gradient compression with error feedback (the counterpart of
``src/repro/train/compression.py``).

* ``int8`` — per-tensor symmetric quantization (scale = max|g| / 127);
* ``topk`` — keep the largest-magnitude fraction per tensor, ties at the
  threshold kept (``>=``, as ``jax.lax.top_k``'s k-th value keeps them),
  with error feedback [Seide et al. 2014; Stich et al. 2018].

A "tensor" is a leaf of the reference's tree: the port's per-layer
tensors of one stacked leaf (``layers.<i>.ssm.in_z`` for every i) share
one scale or one threshold, over all their layers, as the reference's
stacked leaf does.  ``compress_decompress`` is the wire round trip the
optimizer sees; ``EFState`` carries the residuals across steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.convert import reference_leaf


def _groups(grads: dict[str, torch.Tensor]) -> dict[str, list[str]]:
    """The port's names by the reference leaf they belong to, in layer
    order."""
    groups: dict[str, list[str]] = {}
    for name in grads:
        groups.setdefault(reference_leaf(name)[0], []).append(name)
    return groups


def _int8_roundtrip(gs: list[torch.Tensor]) -> list[torch.Tensor]:
    amax = torch.stack([g.abs().max() for g in gs]).max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return [torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            .float() * scale for g in gs]


def _topk_roundtrip(gs: list[torch.Tensor], frac: float = 0.05
                    ) -> list[torch.Tensor]:
    flat = torch.cat([g.reshape(-1) for g in gs])
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return [torch.where(g.abs() >= thresh, g, 0.0) for g in gs]


def compress_decompress(grads: dict[str, torch.Tensor],
                        method: str = "int8", topk_frac: float = 0.05
                        ) -> dict[str, torch.Tensor]:
    """The wire round trip of every gradient, float32."""
    if method == "int8":
        trip = _int8_roundtrip
    elif method == "topk":
        def trip(gs):
            return _topk_roundtrip(gs, topk_frac)
    else:
        raise ValueError(f"unknown compression method {method!r}")
    out = {}
    for names in _groups(grads).values():
        for name, g in zip(names, trip([grads[n].float() for n in names])):
            out[name] = g
    return {name: out[name] for name in grads}


@dataclass
class EFState:
    residual: dict[str, torch.Tensor]

    @staticmethod
    def init(params: dict[str, torch.Tensor]) -> "EFState":
        return EFState({n: torch.zeros_like(p, dtype=torch.float32)
                        for n, p in params.items()})


def compress_with_error_feedback(grads: dict[str, torch.Tensor],
                                 ef: EFState, method: str = "topk",
                                 topk_frac: float = 0.05):
    """g' = C(g + e);  e' = (g + e) − g'.  Returns (g', new EFState)."""
    carried = {n: g.float() + ef.residual[n] for n, g in grads.items()}
    sent = compress_decompress(carried, method, topk_frac)
    return sent, EFState({n: carried[n] - sent[n] for n in carried})


def compressed_bytes_ratio(method: str, topk_frac: float = 0.05) -> float:
    """Wire-byte ratio against float32."""
    if method == "int8":
        return 0.25
    if method == "topk":
        return topk_frac * 2.0       # value + index per kept entry
    return 1.0
