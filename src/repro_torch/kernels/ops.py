"""The kernel dispatch the engines call.

A call whose tensors lie on the CPU takes the kernel's plain version
(:mod:`.ref`); a call on CUDA tensors launches the hand-written kernel or
raises.  There is no fallback from a failed build or launch.
"""

from __future__ import annotations

import torch

from .ref import masked_select_ref
from .select_move import masked_select_fwd


def masked_select(valid: torch.Tensor, util: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked move-selection reduction (the batched planner's inner
    kernel): valid (M, D) bool/uint8, util (D,) → (any (M,) bool,
    dst (M,) int32) — per candidate row, whether any destination is
    legal and the emptiest legal destination (min util, ties → lowest
    device index, 0 where none is legal)."""
    if valid.device.type == "cpu" and util.device.type == "cpu":
        return masked_select_ref(valid, util)
    return masked_select_fwd(valid, util)
