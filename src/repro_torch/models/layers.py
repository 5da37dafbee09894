"""Layer primitives: norms, rotary embeddings, attention (GQA /
sliding-window / softcap / qk-norm), the gated MLP and the chunked
cross-entropy loss.

Functions take parameters as a mapping (``p["wq"]``) laid out as the
reference's parameter tree; parameters are float32 and are cast to the
activations' dtype at each use.  Attention with more than 8 queries runs
the flash forward through :func:`repro_torch.kernels.ops.flash_attention`:
K2 on CUDA tensors, its plain online-softmax version on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, NO_WINDOW, attention_mask

from .common import ModelConfig


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm with scale ``1 + w`` (a zero weight is the identity),
    computed in float32 and returned in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary embeddings


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x`` (B, S, H, Dh) by angles of the (B, S) ``positions``
    (M-RoPE, the VLM family's, is not ported yet)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)         # (dh/2,)
    angles = positions.float()[..., None] * freqs             # (B, S, dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention


def _direct_attention(q, k, v, *, causal, q_offset, window, scale, cap,
                      kv_len_mask):
    """Small-Tq (decode) path: one full masked product, float32 out."""
    Tq, Tk = q.shape[1], k.shape[1]
    qf = q.float() * scale
    logits = softcap(torch.einsum("btkgd,bukd->btkgu", qf, k.float()), cap)
    q_pos = q_offset + torch.arange(Tq, device=q.device)
    kv_pos = torch.arange(Tk, device=q.device)
    limit = Tk if kv_len_mask is None else kv_len_mask
    mask = attention_mask(q_pos, kv_pos, causal, window, limit)
    logits = torch.where(mask[None, :, None, None, :], logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.einsum("btkgu,bukd->btkgd", p, v.float())
    return out / torch.clamp(p.sum(dim=-1)[..., None], min=1e-30)


def attention(q, k, v, *, causal=True, q_offset=0, window=None,
              logit_scale=None, cap=None, kv_block=512, kv_len_mask=None):
    """Attention over (B, Tq, H, Dh) queries and (B, Tk, KV, Dh) keys and
    values → (B, Tq, H, Dh) in q's dtype.

    Tq > 8 → flash through :func:`ops.flash_attention` (full-sequence
    train/prefill); Tq ≤ 8 → the direct masked product (decode, with a
    query offset and a KV length mask)."""
    B, Tq, H, Dh = q.shape
    KV = k.shape[2]
    if logit_scale is None:
        logit_scale = 1.0 / math.sqrt(Dh)
    if Tq > 8:
        if q_offset != 0 or kv_len_mask is not None:
            raise ValueError("the flash path expects full-sequence "
                             "train/prefill: no q_offset or kv_len_mask")
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   cap=cap, scale=logit_scale,
                                   kv_block=kv_block)
    win = NO_WINDOW if window is None else window
    out = _direct_attention(q.reshape(B, Tq, KV, H // KV, Dh), k, v,
                            causal=causal, q_offset=q_offset, window=win,
                            scale=logit_scale, cap=cap,
                            kv_len_mask=kv_len_mask)
    return out.reshape(B, Tq, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention layer (projections + rope + cache plumbing)


def attn_params_shape(cfg: ModelConfig) -> dict:
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {
        "wq": (D, H, Dh), "wk": (D, KV, Dh), "wv": (D, KV, Dh),
        "wo": (H, Dh, D),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = (Dh,)
        shapes["k_norm"] = (Dh,)
    return shapes


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, T, D) · w (D, *out) in x's dtype → (B, T, *out)."""
    D = w.shape[0]
    return (x @ w.to(x.dtype).reshape(D, -1)).reshape(*x.shape[:-1],
                                                       *w.shape[1:])


def attn_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions):
    """The attention sublayer's queries, keys and values for x (B, T, D):
    projections, qk-norm where the config has it, then RoPE at
    ``positions`` (B, T) unless None."""
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Attention (B, T, H, Dh) through the output projection → (B, T, D)."""
    B, T = out.shape[:2]
    H, Dh = cfg.n_heads, cfg.head_dim
    return out.reshape(B, T, H * Dh) @ p["wo"].to(out.dtype).reshape(H * Dh,
                                                                     -1)


def attn_apply(p, x: torch.Tensor, cfg: ModelConfig, *, positions,
               causal=True, window=None, cache=None):
    """Attention sublayer → (out (B, T, D), new cache).  ``cache`` =
    (k, v, length) with k/v (B, S_max, KV, Dh) for decode, length a
    Python int; None for train/prefill.

    The new keys and values are written into the cache's k and v in
    place, which are handed back: the caller owns the cache.  They land
    at ``min(length, S_max - T)``, as the reference's
    ``dynamic_update_slice_in_dim`` clamps its start, so a cache that
    has run past its end takes them in its last slots; the query offset
    stays ``length`` and the key length mask ``length + T``."""
    T = x.shape[1]
    q, k, v = attn_qkv(p, x, cfg, positions)
    kv_len_mask, q_offset = None, 0
    new_cache = None
    if cache is not None:
        ck, cv, clen = cache
        at = min(clen, ck.shape[1] - T)
        ck[:, at:at + T] = k.to(ck.dtype)
        cv[:, at:at + T] = v.to(cv.dtype)
        new_cache = (ck, cv, clen + T)
        k, v = ck, cv
        kv_len_mask, q_offset = clen + T, clen
    out = attention(q, k, v, causal=causal, q_offset=q_offset, window=window,
                    cap=cfg.attn_softcap, kv_len_mask=kv_len_mask)
    return attn_out(p, out, cfg), new_cache


def attn_ring_step(p, x: torch.Tensor, cfg: ModelConfig, *, positions,
                   cache):
    """One decode token of an all-sliding-window layer, whose cache is a
    ring of S_max = min(window, max_len) slots: the key and value go to
    slot ``length % S_max`` (in place, as :func:`attn_apply` writes) and
    the query attends to every live slot, ``min(length + 1, S_max)`` of
    them, without a causal or window mask — every live entry is inside
    the window.  → (out (B, 1, D), (k, v, length + 1))."""
    ck, cv, clen = cache
    S_max = ck.shape[1]
    q, k, v = attn_qkv(p, x, cfg, positions)
    at = clen % S_max
    ck[:, at:at + 1] = k.to(ck.dtype)
    cv[:, at:at + 1] = v.to(cv.dtype)
    out = attention(q, ck, cv, causal=False, cap=cfg.attn_softcap,
                    kv_len_mask=min(clen + 1, S_max))
    return attn_out(p, out, cfg), (ck, cv, clen + 1)


# ---------------------------------------------------------------------------
# Gated MLP


def mlp_params_shape(cfg: ModelConfig) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {"w_in": (D, F_), "w_gate": (D, F_), "w_out": (F_, D)}


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU (``mlp_act="silu"``) or GeGLU with the tanh gelu."""
    h = x @ p["w_in"].to(x.dtype)
    g = (x @ p["w_gate"].to(x.dtype)).float()
    act = F.silu(g) if cfg.mlp_act == "silu" else F.gelu(g, approximate="tanh")
    return (h * act.to(x.dtype)) @ p["w_out"].to(x.dtype)


# ---------------------------------------------------------------------------
# Losses


def _xent_chunk(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                final_softcap: float | None):
    """One chunk's (summed NLL float32, valid label count)."""
    logits = softcap((h @ w.T).float(), final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    valid = labels >= 0
    return torch.where(valid, lse - gold, 0.0).sum(), valid.sum()


def chunked_softmax_xent(hidden: torch.Tensor, w_unembed: torch.Tensor,
                         labels: torch.Tensor, cfg: ModelConfig,
                         final_softcap: float | None = None
                         ) -> torch.Tensor:
    """Sequence-chunked cross entropy, mean NLL over the labels that are
    not -1: hidden (B, S, D), w_unembed (V, D), labels (B, S) → a float32
    scalar.  The unembedding is cast to hidden's dtype once; S is padded
    to a multiple of ``cfg.loss_chunk`` with label -1; each chunk's
    logits are float32 and soft-capped.  Under grad mode each chunk runs
    under ``torch.utils.checkpoint``, as the reference's scan body runs
    under ``nothing_saveable``: the backward recomputes a chunk's
    (B, chunk, V) logits instead of holding every chunk's."""
    B, S, D = hidden.shape
    chunk = min(cfg.loss_chunk, S)
    n = -(-S // chunk)
    w = w_unembed.to(hidden.dtype)
    labels = labels.long()
    pad = n * chunk - S
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    remat = torch.is_grad_enabled()
    for i in range(0, n * chunk, chunk):
        args = (hidden[:, i:i + chunk], w, labels[:, i:i + chunk],
                final_softcap)
        nll, valid = (checkpoint(_xent_chunk, *args, use_reentrant=False,
                                 preserve_rng_state=False)
                      if remat else _xent_chunk(*args))
        total = total + nll
        count = count + valid
    return total / torch.clamp(count, min=1)
