"""Plain PyTorch versions of the port's kernels: what the CPU tests run,
and what ``chip_smoke.py`` holds each kernel to on the card."""

from __future__ import annotations

import torch


def masked_select_ref(valid: torch.Tensor, util: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked move-selection reduction, plain version of K1.

    valid: (M, D) bool/uint8 — legality of destination d for candidate
    row m; util: (D,) float32/float64 — device utilizations.  Returns per
    row ``any`` (M,) bool — the row has a legal destination — and ``dst``
    (M,) int32 — the first-occurrence argmin of
    ``where(valid, util, +inf)``: the emptiest legal destination, ties to
    the lowest device index, and 0 for a row with no legal destination.

    The tie-break is explicit (the row minimum first, then the lowest
    index holding it) rather than left to ``torch.argmin``.
    """
    valid = valid != 0
    masked = torch.where(valid, util[None, :], float("inf"))
    best = masked.amin(dim=1, keepdim=True)
    n = valid.shape[1]
    iota = torch.arange(n, device=valid.device)
    dst = torch.where(masked == best, iota, n).amin(dim=1)
    return valid.any(dim=1), dst.to(torch.int32)
