"""What TMA can read, for the wrappers of the tensor-core kernels (K2's
and K3's): the Python side of ``csrc/hopper.cuh``."""

from __future__ import annotations

#: TMA's alignment of a base address and of every stride, in bytes
TMA_ALIGN = 16


def check_tma_layout(name: str, data_ptr: int, strides: tuple[int, ...],
                     element_size: int) -> None:
    """Raise ValueError unless TMA can read the operand ``name``: its data
    pointer and each of its (B, T, head) element ``strides`` must be a
    positive multiple of :data:`TMA_ALIGN` bytes."""
    if data_ptr % TMA_ALIGN or any(
            s <= 0 or s * element_size % TMA_ALIGN for s in strides):
        raise ValueError(
            f"the tensor-core kernel reads {name} with TMA, which needs "
            f"its data pointer and (B, T, head) strides to be positive "
            f"multiples of {TMA_ALIGN} bytes; got pointer {data_ptr:#x}, "
            f"strides {tuple(strides)} of {element_size}-byte elements")
