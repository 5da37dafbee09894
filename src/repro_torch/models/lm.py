"""Language-model assembly: the prefill trunk as ``nn.Module``s.

Ported families: the SSM+shared-attention hybrid (zamba2), the
attention-free SSD stack (mamba2) and the dense decoder without MoE.
MoE, encoder–decoder and non-token inputs raise ``NotImplementedError``
(ROADMAP.md queue 1, item 9(d)).  An :class:`LM` owns one module per
layer — an :class:`SSDBlock` or an :class:`AttnMLPBlock` — and, for the
hybrid, one shared :class:`AttnMLPBlock` applied before every
``shared_attn_every``-th layer.  Parameters are float32, named as the
reference's parameter tree (``layers.3.ssm.in_z`` is the reference's
``layers/ssm/in_z[3]``), and cast to ``cfg.dtype`` at each use.

Entry points: :func:`build_model` (seeded random weights) or
:func:`repro_torch.models.convert.params_from_numpy` (the reference's
weights), then :func:`prefill` — last-token logits.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import resolve_device

from .common import ModelConfig
from .layers import (NO_WINDOW, attn_apply, attn_params_shape, mlp_apply,
                     mlp_params_shape, rms_norm, softcap)
from .ssm import ssm_apply, ssm_params_shape

_NORMS = ("ln", "ln1", "ln2", "ln_x", "final_norm", "out_norm", "q_norm",
          "k_norm")
_RESIDUAL_OUT = ("wo", "w_out", "out_proj")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.family not in ("dense", "ssm", "hybrid") or cfg.n_experts \
            or cfg.is_enc_dec or cfg.input_mode != "tokens" \
            or cfg.mrope_sections:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (experts {cfg.n_experts}, "
            f"encoder layers {cfg.n_enc_layers}, input {cfg.input_mode!r}) "
            f"is not ported yet; see ROADMAP.md queue 1, item 9(d)")


# ---------------------------------------------------------------------------
# Parameter shape trees


def block_shapes(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        return {"ln": (D,), "ssm": ssm_params_shape(cfg)}
    return shared_block_shapes(cfg)


def shared_block_shapes(cfg: ModelConfig) -> dict:
    """Attention + MLP: a dense layer, and zamba2's shared block (one
    parameter set reused at every application point)."""
    D = cfg.d_model
    return {"ln1": (D,), "attn": attn_params_shape(cfg), "ln2": (D,),
            "mlp": mlp_params_shape(cfg)}


def model_shapes(cfg: ModelConfig) -> dict:
    """The reference's parameter tree with per-layer (unstacked) shapes."""
    check_ported(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    shapes: dict = {"embed": (V, D), "final_norm": (D,),
                    "layers": block_shapes(cfg)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (V, D)
    if cfg.family == "hybrid":
        shapes["shared"] = shared_block_shapes(cfg)
    return shapes


# ---------------------------------------------------------------------------
# Modules


class ParamTree(nn.Module):
    """float32 parameters laid out as a shape tree; ``p["name"]`` reads a
    leaf or a subtree, as the layer functions expect."""

    def __init__(self, shapes: dict, device: torch.device):
        super().__init__()
        for name, node in sorted(shapes.items()):
            if isinstance(node, dict):
                self.add_module(name, ParamTree(node, device))
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(node, dtype=torch.float32, device=device),
                    requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


class SSDBlock(ParamTree):
    """One Mamba-2 layer: ``x + ssm(rms_norm(x))``."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__(block_shapes(cfg), device)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, positions=None,
                window=None) -> torch.Tensor:
        """``positions`` and ``window`` are the attention blocks'; an SSD
        layer has neither."""
        h, _ = ssm_apply(self["ssm"], rms_norm(x, self["ln"],
                                               self.cfg.norm_eps), self.cfg)
        return x + h


class AttnMLPBlock(ParamTree):
    """Attention then gated MLP, each residual around an RMS norm: a
    dense layer, or zamba2's shared block."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__(shared_block_shapes(cfg), device)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                window: int | None = None) -> torch.Tensor:
        eps = self.cfg.norm_eps
        h, _ = attn_apply(self["attn"], rms_norm(x, self["ln1"], eps),
                          self.cfg, positions=positions, causal=True,
                          window=window)
        x = x + h
        return x + mlp_apply(self["mlp"], rms_norm(x, self["ln2"], eps),
                             self.cfg)


class LM(nn.Module):
    """The decoder trunk with its embedding and unembedding; parameters
    are allocated uninitialised on ``device`` (fill them with
    :func:`init_params` or :func:`~repro_torch.models.convert
    .params_from_numpy`)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        shapes = model_shapes(cfg)
        self.cfg = cfg

        def leaf(shape):
            return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                            device=device),
                                requires_grad=False)

        self.embed = leaf(shapes["embed"])
        self.final_norm = leaf(shapes["final_norm"])
        self.unembed = leaf(shapes["unembed"]) if "unembed" in shapes \
            else None
        block = SSDBlock if cfg.family in ("ssm", "hybrid") else AttnMLPBlock
        self.layers = nn.ModuleList(block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.shared = AttnMLPBlock(cfg, device) \
            if cfg.family == "hybrid" else None

    def forward(self, batch: dict) -> torch.Tensor:
        return prefill(self, batch)


# ---------------------------------------------------------------------------
# Initialisation


def ssd_ramps(n_heads: int, dtype: torch.dtype = torch.float32,
              device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD heads' step sizes and decays at initialisation, from which
    the reference sets ``dt_bias`` and ``A_log``: dt log-spaced from 1e-3
    to 1e-1 and A = -(1 .. 16), over the heads."""
    dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), n_heads,
                                  dtype=dtype, device=device))
    A = -torch.linspace(1.0, 16.0, n_heads, dtype=dtype, device=device)
    return dt, A


def _init_leaf(param: torch.Tensor, name: str, cfg: ModelConfig,
               gen: torch.Generator) -> None:
    """The reference's per-leaf distributions: zero RMS scales (scale
    ≡ 1 + 0), the ``A_log`` and ``dt_bias`` ramps, unit ``D_skip``, zero
    conv bias, and normal weights — 0.02 for the embeddings, 0.02 /
    sqrt(2 L) for the residual output projections, 1 / sqrt(fan_in)
    otherwise."""
    shape = tuple(param.shape)
    with torch.no_grad():
        if name in _NORMS or name == "conv_b":
            param.zero_()
        elif name == "A_log":
            param.copy_(torch.log(-ssd_ramps(shape[0])[1]))
        elif name == "dt_bias":
            dt = ssd_ramps(shape[0], torch.float64)[0]
            param.copy_(torch.log(torch.expm1(dt)))
        elif name == "D_skip":
            param.fill_(1.0)
        else:
            fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
            if name in _RESIDUAL_OUT:
                scale = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
            elif name in ("embed", "unembed"):
                scale = 0.02
            else:
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            param.normal_(0.0, scale, generator=gen)


def init_params(model: LM, seed: int = 0) -> LM:
    """Fill ``model``'s parameters in place from a ``torch.Generator`` on
    the model's device seeded with ``seed``.  The values follow the
    reference's distributions, not its random bits.  On the meta device,
    which holds shapes and no values, there is nothing to fill."""
    device = model.embed.device
    if device.type == "meta":
        return model
    gen = torch.Generator(device=device).manual_seed(seed)
    for dotted, param in model.named_parameters():
        _init_leaf(param, dotted.rsplit(".", 1)[-1], model.cfg, gen)
    return model


def build_model(cfg: ModelConfig, *, seed: int = 0, device=None) -> LM:
    """An :class:`LM` for ``cfg`` with seeded random weights, on the card
    unless ``device`` names another."""
    return init_params(LM(cfg, resolve_device(device, "the LM")), seed)


# ---------------------------------------------------------------------------
# Forward


def window_schedule(cfg: ModelConfig) -> list[int] | None:
    """Per-layer sliding window (gemma2 alternating, mixtral all)."""
    if cfg.swa_pattern == "none" or cfg.sliding_window is None:
        return None
    if cfg.swa_pattern == "all":
        return [cfg.sliding_window] * cfg.n_layers
    # alternating: even layers local, odd layers global
    return [cfg.sliding_window if i % 2 == 0 else NO_WINDOW
            for i in range(cfg.n_layers)]


def forward_hidden(model: LM, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """Embed-less trunk: x (B, T, D) → hidden (B, T, D).  Each block's
    forward is the reference's ``_block_apply``; the hybrid's shared
    block (its ``_shared_attn_apply``) runs before every
    ``shared_attn_every``-th layer, with full attention."""
    cfg = model.cfg
    windows = window_schedule(cfg)
    every = max(cfg.shared_attn_every, 1)
    for i, block in enumerate(model.layers):
        if model.shared is not None and i % every == 0:
            x = model.shared(x, positions)
        x = block(x, positions, None if windows is None else windows[i])
    return x


def embed_tokens(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table in ``cfg.dtype`` (gathered, then cast:
    the same values as casting the table first)."""
    return model.embed[tokens].to(getattr(torch, model.cfg.dtype))


def prefill(model: LM, batch: dict) -> torch.Tensor:
    """Prefill forward: tokens (B, S) → last-token logits (B, V) float32."""
    cfg = model.cfg
    tokens = batch["tokens"]
    x = embed_tokens(model, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    hidden = forward_hidden(model, x, positions)
    last = rms_norm(hidden[:, -1], model.final_norm, cfg.norm_eps)
    w_un = model.embed if model.unembed is None else model.unembed
    logits = last @ w_un.to(last.dtype).T
    return softcap(logits.float(), cfg.final_softcap)
