"""Language-model assembly: the training loss, the prefill trunk and the
decode step as ``nn.Module``s.

Ported families: the SSM+shared-attention hybrid (zamba2), the
attention-free SSD stack (mamba2) and the dense decoder without MoE.
MoE, encoder–decoder and non-token inputs raise ``NotImplementedError``
(ROADMAP.md queue 1, item 9(d)).  An :class:`LM` owns one
:class:`ParamTree` per layer — an SSD layer's (:func:`ssd_block`) or an
attention and MLP layer's (:func:`attn_mlp_block`) — and, for the
hybrid, one shared attention and MLP block applied before every
``shared_attn_every``-th layer.  Parameters are float32, named as the
reference's parameter tree (``layers.3.ssm.in_z`` is the reference's
``layers/ssm/in_z[3]``), and cast to ``cfg.dtype`` at each use.

Entry points: :func:`build_model` (seeded random weights) or
:func:`repro_torch.models.convert.params_from_numpy` (the reference's
weights), then :func:`loss_fn` — the training loss, on the model's own
parameters or on a dict of compute tensors in their place (the train
step's, :mod:`repro_torch.train`) — :func:`prefill` — last-token logits
— or :func:`init_cache` and :func:`decode_step`, one token at a time
against static-shape caches (the serving path,
:mod:`repro_torch.serve.engine`).

The forward reads its parameters from a tree: the :class:`LM` itself
(``model["layers"][3]["ssm"]["in_z"]``) or :func:`param_tree`'s nesting
of a flat dict of tensors (``loss_fn``'s ``params``).  Under grad mode
the training forward rematerialises each layer as ``cfg.remat`` says
(:func:`_remat`).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device

from .common import ModelConfig
from .layers import (NO_WINDOW, attn_apply, attn_params_shape,
                     attn_ring_step, chunked_softmax_xent, mlp_apply,
                     mlp_params_shape, rms_norm, softcap)
from .ssm import ssm_apply, ssm_cache_init, ssm_params_shape

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


def ssd_block(p, x: torch.Tensor, cfg: ModelConfig, positions=None,
              window=None, cache=None) -> torch.Tensor:
    """One Mamba-2 layer over parameters ``p``: ``x + ssm(rms_norm(x))``.
    ``positions`` and ``window`` are the attention blocks'; an SSD layer
    has neither.  ``cache`` = (ssd, conv), the layer's decode state, which
    a decode token advances in place."""
    h, new = ssm_apply(p["ssm"], rms_norm(x, p["ln"], cfg.norm_eps), cfg,
                       cache=cache)
    if cache is not None:
        for held, state in zip(cache, new):
            held.copy_(state)
    return x + h


def attn_mlp_block(p, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, window: int | None = None,
                   cache=None) -> torch.Tensor:
    """Attention then gated MLP over parameters ``p``, each residual
    around an RMS norm: a dense layer, or zamba2's shared block.
    ``cache`` = (k, v, length), the layer's decode cache, written in
    place: a ring for an all-sliding-window config, else a linear buffer
    (:func:`~.layers.attn_apply`)."""
    eps = cfg.norm_eps
    hn = rms_norm(x, p["ln1"], eps)
    if cache is not None and _rolling(cfg):
        h, _ = attn_ring_step(p["attn"], hn, cfg, positions=positions,
                              cache=cache)
    else:
        h, _ = attn_apply(p["attn"], hn, cfg, positions=positions,
                          causal=True, window=window, cache=cache)
    x = x + h
    return x + mlp_apply(p["mlp"], rms_norm(x, p["ln2"], eps), cfg)


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
        self.layers = nn.ModuleList(ParamTree(shapes["layers"], device)
                                    for _ in range(cfg.n_layers))
        self.shared = ParamTree(shapes["shared"], device) \
            if "shared" in shapes else None

    def __getitem__(self, name: str):
        """The reference tree's top level: ``embed``, ``final_norm``,
        ``unembed`` (None when tied), ``layers`` (indexed by layer),
        ``shared`` (None but for the hybrid)."""
        return getattr(self, name)

    def forward(self, batch: dict) -> torch.Tensor:
        return prefill(self, batch)


def param_tree(model: LM, params: dict[str, torch.Tensor] | None = None):
    """The tree the forward reads its parameters from: ``model`` itself,
    or, given ``params`` — a tensor for every name of
    ``model.named_parameters()`` and no other — those tensors nested the
    same way (``tree["layers"][i]["ssm"]["in_z"]`` is
    ``params["layers.<i>.ssm.in_z"]``), with ``unembed`` and ``shared``
    None where the model has none.  The train step runs the model on its
    compute tensors this way."""
    if params is None:
        return model
    names = [n for n, _ in model.named_parameters()]
    if set(params) != set(names):
        raise KeyError(f"params must name exactly the model's parameters; "
                       f"missing {sorted(set(names) - set(params))}, "
                       f"extra {sorted(set(params) - set(names))}")
    tree: dict = {}
    for dotted in names:
        *path, leaf = dotted.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = params[dotted]
    tree["layers"] = [tree["layers"][str(i)]
                      for i in range(model.cfg.n_layers)]
    return {"unembed": None, "shared": None, **tree}


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


def _rolling(cfg: ModelConfig) -> bool:
    """All-sliding-window configs decode against a ring buffer."""
    return cfg.swa_pattern == "all" and cfg.sliding_window is not None


#: the matrix products that ``remat="dots"`` saves: those without batch
#: dimensions (the projections), as the reference's
#: ``checkpoint_dots_with_no_batch_dims`` policy
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``fn(x)`` rematerialised as ``cfg.remat`` says, the reference's
    ``_maybe_remat``: ``"none"`` saves every activation; ``"full"`` (every
    config's default) saves only ``x`` and recomputes the layer in the
    backward pass; any other value saves the projections' products too
    (selective checkpointing).  Only a forward that builds a graph is
    wrapped; remat changes no value."""
    if cfg.remat == "none" or not (torch.is_grad_enabled()
                                   and x.requires_grad):
        return fn(x)
    extra = {} if cfg.remat == "full" else {
        "context_fn": lambda: create_selective_checkpoint_contexts(
            _save_dots)}
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False,
                      **extra)


def forward_hidden(model: LM, x: torch.Tensor, positions: torch.Tensor,
                   cache: dict | None = None, tree=None) -> torch.Tensor:
    """Embed-less trunk: x (B, T, D) → hidden (B, T, D), on the
    parameters of ``tree`` (:func:`param_tree`; the model's own if None).
    Each block's forward is the reference's ``_block_apply``; the
    hybrid's shared block (its ``_shared_attn_apply``) runs before every
    ``shared_attn_every``-th layer, with full attention, inside that
    layer's remat (:func:`_remat`).  With a decode ``cache``
    (:func:`init_cache`) each layer reads and writes its own slice of it;
    the shared block's ``a``-th application, before layer
    ``a * shared_attn_every``, uses attention cache ``a``."""
    cfg = model.cfg
    P = model if tree is None else tree
    windows = window_schedule(cfg)
    every = max(cfg.shared_attn_every, 1)
    block = ssd_block if cfg.family in ("ssm", "hybrid") else attn_mlp_block
    for i in range(cfg.n_layers):
        shared = P["shared"] is not None and i % every == 0
        if cache is None:
            attn_cache = layer_cache = None
        else:
            attn_cache = (cache["k"][i // every], cache["v"][i // every],
                          cache["len"]) if shared else None
            layer_cache = (cache["ssd"][i], cache["conv"][i]) \
                if "ssd" in cache else \
                (cache["k"][i], cache["v"][i], cache["len"])

        def layer(h, i=i, shared=shared, attn_cache=attn_cache,
                  layer_cache=layer_cache):
            if shared:
                h = attn_mlp_block(P["shared"], h, cfg, positions,
                                   cache=attn_cache)
            return block(P["layers"][i], h, cfg, positions,
                         None if windows is None else windows[i],
                         cache=layer_cache)

        x = layer(x) if cache is not None else _remat(layer, x, cfg)
    return x


def embed_tokens(P, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """Rows of ``P["embed"]`` in ``cfg.dtype`` (gathered, then cast: the
    same values as casting the table first)."""
    return P["embed"][tokens].to(getattr(torch, cfg.dtype))


def _unembedding(P) -> torch.Tensor:
    return P["embed"] if P["unembed"] is None else P["unembed"]


def _last_logits(P, hidden: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """The last position's final norm and unembedding → (B, V) float32,
    soft-capped."""
    last = rms_norm(hidden[:, -1], P["final_norm"], cfg.norm_eps)
    logits = last @ _unembedding(P).to(last.dtype).T
    return softcap(logits.float(), cfg.final_softcap)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None].expand(B, S)


def prefill(model: LM, batch: dict) -> torch.Tensor:
    """Prefill forward: tokens (B, S) → last-token logits (B, V) float32."""
    tokens = batch["tokens"]
    x = embed_tokens(model, tokens, model.cfg)
    return _last_logits(model, forward_hidden(model, x, _positions(tokens)),
                        model.cfg)


def loss_fn(model: LM, batch: dict,
            params: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
    """Training loss, the reference's ``loss_fn`` for the ported families:
    ``batch`` holds ``tokens`` and ``labels`` (B, S) (label -1: not
    counted); embedding, the trunk (rematerialised per ``cfg.remat``),
    the final norm and :func:`~.layers.chunked_softmax_xent` over the
    unembedding (the embedding when tied) → the mean NLL, a float32
    scalar.  ``params`` (:func:`param_tree`) runs the model on those
    tensors in place of its own parameters."""
    cfg = model.cfg
    check_ported(cfg)
    P = param_tree(model, params)
    tokens = batch["tokens"]
    x = embed_tokens(P, tokens, cfg)
    hidden = forward_hidden(model, x, _positions(tokens), tree=P)
    hidden = rms_norm(hidden, P["final_norm"], cfg.norm_eps)
    return chunked_softmax_xent(hidden, _unembedding(P), batch["labels"],
                                cfg, final_softcap=cfg.final_softcap)


# ---------------------------------------------------------------------------
# Serving: static-shape caches and the one-token decode step


def cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode cache's tensor leaves as meta tensors (shape and dtype,
    no storage), each the reference's leaf, stacked on a leading layer
    axis: ``ssd`` (L, B, H, P, N) float32 and ``conv`` (L, B, K-1,
    conv_dim) for the SSD layers; ``k`` and ``v`` (n, B, S, KV, Dh) for
    attention — n the hybrid's shared-block applications or the dense
    layers, S ``max_len``, or min(window, max_len) for an
    all-sliding-window ring.  The reference's ``len`` leaf is kept on
    the host (:func:`init_cache`)."""
    check_ported(cfg)
    KV, Dh, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    dt = getattr(torch, cfg.dtype)

    def meta(shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    spec = {}
    if cfg.family in ("ssm", "hybrid"):
        ssd, conv = ssm_cache_init(cfg, batch, dt, device="meta")
        spec = {"ssd": meta((L, *ssd.shape), ssd.dtype),
                "conv": meta((L, *conv.shape))}
        if cfg.family == "ssm":
            return spec
        n_attn = -(-L // max(cfg.shared_attn_every, 1))
        kv = (n_attn, batch, max_len, KV, Dh)
    else:
        window = (min(cfg.sliding_window, max_len)
                  if cfg.swa_pattern == "all" and cfg.sliding_window
                  else max_len)
        kv = (L, batch, window, KV, Dh)
    return {**spec, "k": meta(kv), "v": meta(kv)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """A zero cache of :func:`cache_spec`'s leaves on ``device`` (the
    card unless named; pass the model's), with ``len`` 0: a Python int,
    so that a step reads nothing back from the device."""
    device = resolve_device(device, "the decode cache")
    cache = {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
             for name, s in cache_spec(cfg, batch, max_len).items()}
    cache["len"] = 0
    return cache


def decode_step(model: LM, cache: dict, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode: tokens (B, 1) → (logits (B, V) float32,
    soft-capped; the cache).  Every row sits at position ``cache["len"]``.
    The cache's tensors are updated in place and its ``len`` advanced by
    one; the same dict is handed back.  Past ``max_len`` a linear cache
    keeps writing its last slot, as the reference's clamped update does
    (:func:`~.layers.attn_apply`)."""
    x = embed_tokens(model, tokens, model.cfg)
    positions = torch.full((tokens.shape[0], 1), cache["len"],
                           device=x.device)
    logits = _last_logits(model, forward_hidden(model, x, positions, cache),
                          model.cfg)
    cache["len"] += 1
    return logits, cache
