"""Architecture × input-shape registry of the LM scaffold.

``SHAPES`` are the assigned LM shapes: ``train_4k`` for the training
step, ``prefill_32k`` for the prefill trunk, ``decode_32k`` /
``long_500k`` for one serve step against a seq_len-sized cache.  Of the
ten architectures ``zamba2-7b``, ``mamba2-2.7b`` and ``qwen3-0.6b`` (the
serving launcher's default) are ported so far;
:func:`get_config` raises ``NotImplementedError`` for the others
(ROADMAP.md queue 1, item 9(d)).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.models.common import ModelConfig

ARCHS = {
    "stablelm-12b": "stablelm_12b",
    "gemma2-9b": "gemma2_9b",
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-8b": "granite_8b",
    "mixtral-8x7b": "mixtral_8x7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mamba2-2.7b": "mamba2_2_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "zamba2-7b": "zamba2_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

#: architectures whose configuration and forward the port has
PORTED = ("zamba2-7b", "mamba2-2.7b", "qwen3-0.6b")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}; known: "
                       f"{', '.join(ARCHS)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch} is not ported to repro_torch yet (ported: "
            f"{', '.join(PORTED)}); see ROADMAP.md queue 1, item 9(d)")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").CONFIG
