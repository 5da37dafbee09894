"""The port's LM scaffold: the prefill trunk and the decode step of the
hybrid (zamba2), SSD and dense families as ``nn.Module``s, with K2 and
K3 on the card."""

from .common import ModelConfig, param_count
from .convert import params_from_numpy
from .lm import (LM, build_model, cache_spec, decode_step, init_cache,
                 init_params, model_shapes, prefill)

__all__ = ["ModelConfig", "param_count", "LM", "build_model", "cache_spec",
           "decode_step", "init_cache", "init_params", "model_shapes",
           "params_from_numpy", "prefill"]
