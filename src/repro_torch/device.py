"""Where the port's entry points run: on the card unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device, what: str) -> torch.device:
    """``None`` means the card: CUDA, or raise when there is none.  The
    CPU runs only when the caller names it.  ``what`` names the entry
    point in the error."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what} runs on a CUDA device and none is "
                               f"available; pass device='cpu' to run on the "
                               f"CPU")
        return torch.device("cuda")
    return torch.device(device)
