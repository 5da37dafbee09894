"""Mamba-2 / SSD (state-space duality) blocks [arXiv:2405.21060].

Prefill runs the chunked SSD scan through
:func:`repro_torch.kernels.ops.ssd_scan`: K3 on CUDA tensors, its plain
chunk loop on the CPU — within a chunk the quadratic (dual) form, across
chunks a (B, H, P, N) float32 state.  Decode is the one-token recurrence
:func:`ssd_decode_step` over the state :func:`ssm_cache_init` makes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .common import ModelConfig
from .layers import _proj, rms_norm


def ssm_params_shape(cfg: ModelConfig) -> dict:
    """Projections are separate parameters (z / xBC / dt), as in the
    reference's tree."""
    D, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * G * N
    return {
        "in_z": (D, di),
        "in_xbc": (D, conv_dim),
        "in_dt": (D, H),
        "conv_w": (cfg.ssm_conv, conv_dim),
        "conv_b": (conv_dim,),
        "dt_bias": (H,),
        "A_log": (H,),
        "D_skip": (H,),
        "out_norm": (di,),
        "out_proj": (di, D),
    }


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: torch.Tensor | None = None):
    """Depthwise causal conv1d as the reference writes it: a sum of K
    shifted copies times the float32 taps (so the sum is float32), plus
    the bias, through silu, back in xBC's dtype.  xBC (B, T, C), w (K, C).
    Returns (out, new conv state = the last K-1 inputs)."""
    K, T = w.shape[0], xBC.shape[1]
    if conv_state is None:
        pad = torch.zeros((xBC.shape[0], K - 1, xBC.shape[2]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                        # (B, T+K-1, C)
    out = sum(xp[:, i:i + T] * w[i][None, None, :] for i in range(K))
    out = out + b[None, None, :]
    new_state = xp[:, xp.shape[1] - (K - 1):]
    return F.silu(out.float()).to(xBC.dtype), new_state


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One-token recurrence: state (B, H, P, N), x (B, H, P), dt (B, H),
    Bm/Cm (B, G, N) → (y (B, H, P), new state)."""
    rep = x.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1).float()
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    decay = torch.exp((dt * A[None, :]).float())[:, :, None, None]
    contrib = torch.einsum("bhn,bhp->bhpn", Bh * dt.float()[..., None],
                           x.float())
    state = state * decay + contrib
    y = torch.einsum("bhn,bhpn->bhp", Ch, state)
    return y.to(x.dtype), state


def ssm_apply(p, x: torch.Tensor, cfg: ModelConfig, cache=None):
    """Mamba-2 block: in_proj → conv → SSD → gated norm → out_proj.

    ``cache`` = (ssd_state (B, H, P, N), conv_state (B, K-1, conv_dim))
    for single-token decode; None for train/prefill (the chunked scan).
    Returns (out (B, T, D), new cache or None)."""
    B, T, D = x.shape
    H, P = cfg.ssm_nheads, cfg.ssm_headdim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    di = cfg.d_inner

    z = _proj(x, p["in_z"])
    xBC = _proj(x, p["in_xbc"])
    dt = _proj(x, p["in_dt"]).float() + p["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros((), device=dt.device))   # softplus
    A = -torch.exp(p["A_log"].float())

    conv_state = cache[1] if cache is not None else None
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B, T, H, P)
    Bm = Bm.reshape(B, T, G, N)
    Cm = Cm.reshape(B, T, G, N)

    if cache is None:
        y = ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=min(cfg.ssm_chunk, T))
    else:
        if T != 1:
            raise ValueError("the decode path is single-token")
        y1, state = ssd_decode_step(cache[0], xs[:, 0], dt[:, 0], A,
                                    Bm[:, 0], Cm[:, 0])
        y = y1[:, None]

    y = y + xs * p["D_skip"].float()[None, None, :, None].to(x.dtype)
    y = y.reshape(B, T, di)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, (state, new_conv) if cache is not None else None


def ssm_cache_init(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.float32, device=None):
    """A layer's zero decode state: (ssd (B, H, P, N) float32, conv
    (B, K-1, conv_dim) in ``dtype``)."""
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return (torch.zeros((batch, H, P, N), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                        device=device))
