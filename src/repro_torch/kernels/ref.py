"""Plain PyTorch versions of the port's kernels.

What :mod:`.ops` runs on CPU tensors: K1 ``select_rows_ref`` (the
planner step's selection over ``select_rows_masks``, ending in
``masked_select_ref``) and
``masked_select_ref``, K2 ``flash_attention_online`` (online softmax over KV blocks) and K3
``ssd_chunked`` (the chunk loop), the same schedules as the reference
model's own code.

What the tests and ``chip_smoke.py`` hold the kernels to: K2
``flash_attention_ref`` (one full softmax) and K3 ``ssd_scan_ref`` (the
token-level recurrence), in the kernels' flattened (batch·head) layout,
and ``flash_attention_plain`` / ``ssd_scan_plain`` around them in the
model layout."""

from __future__ import annotations

import math

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


def select_rows_masks(src_order: torch.Tensor, n_avail: torch.Tensor,
                      cap_lim: torch.Tensor, dyn: dict, const: dict,
                      scal: dict) -> dict[str, torch.Tensor]:
    """The masks behind :func:`select_rows_ref`, in the order K1's fused
    kernel tests them: ``live`` (k, R) — a real row whose source-count
    criterion holds; ``pre`` (k, R, n) — live, and every criterion but
    the acting-slot tests and the variance test; ``cand`` (k, R, n) — pre
    with the destination neither a member of the row's PG nor in a
    failure domain its rule step holds; ``valid`` — cand and the variance
    test; ``avail`` (k,) — the source is not parked."""
    # the legality core's package imports the engines, which import this
    # module: bind it at the first call
    from ..core import legality
    d, c, s = dyn, const, scal
    used, util = d["used"], d["util"]
    k = src_order.shape[0]
    iota = torch.arange(used.shape[0], device=used.device)
    avail = torch.arange(k, device=used.device) < n_avail      # (k,)
    rows_k = d["rows_on"][src_order]                           # (k, R)
    real = rows_k >= 0
    r = rows_k.clamp(min=0)             # -1 padding gathers row 0, masked
    pg, lvl, slot = c["sh_pg"][r], c["sh_level"][r], c["sh_slot"][r]
    sbase, scnt = c["sh_sbase"][r], c["sh_scnt"][r]
    pool = c["sh_pool"][r]
    size = torch.where(real, c["sh_size"][r], 0.0)             # (k, R) f64

    # every criterion but the slots' and the variance test
    src_c = src_order[:, None]                                 # (k, 1)
    src_cc = src_order[:, None, None]                          # (k, 1, 1)
    live = real & legality.src_count_ok(d["pool_counts"][pool, src_c],
                                        c["ideal"][pool, src_c], s["slack"])
    u_s = util[src_order][:, None, None]
    pre = (live[..., None] & c["dev_in"] & (iota != src_cc)
           & legality.before_source(util, u_s, iota, src_cc)
           & legality.class_ok(c["sh_class"][r][..., None], c["dev_class"])
           & d["dst_ok"][pool]
           & legality.capacity_ok(used, cap_lim, size[..., None]))

    # not a member, failure domain free: from the acting table, all S
    # slots of each row's PG at once (the reference loops over the slots;
    # one (k, R, S, n) compare per test is the same OR).  Padded slots are
    # -1: never a member, never a peer.
    acting_t = d["acting"][pg]                                 # (k, R, S)
    j = torch.arange(acting_t.shape[2], device=iota.device)
    lo, n_in = sbase[..., None], scnt[..., None]
    in_step = (lo <= j) & (lo + n_in > j) & (slot[..., None] != j)
    peer = torch.where(in_step, c["dev_domain"][lvl[..., None],
                                                acting_t.clamp(min=0)],
                       -1)                     # domain ids are >= 0
    member = (acting_t[..., None] == iota).any(dim=2)          # (k, R, n)
    clash = (c["dev_domain"][lvl][:, :, None, :]
             == peer[..., None]).any(dim=2)
    cand = pre & ~(member | clash)

    # exact variance acceptance (float64, reference operand order)
    var_ok = legality.variance_improves(
        used[src_order][:, None, None], used,
        c["cap"][src_order][:, None, None], c["cap"], u_s, util,
        size[..., None], d["us"], d["usq"], s["n_f"], s["min_dvar"])
    return {"live": live, "pre": pre, "cand": cand, "valid": cand & var_ok,
            "avail": avail}


def select_rows_ref(src_order: torch.Tensor, n_avail: torch.Tensor,
                    cap_lim: torch.Tensor, dyn: dict, const: dict,
                    scal: dict
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batched planner step's selection, plain version of K1's fused
    kernel (:func:`repro_torch.kernels.select_move.select_rows_fwd`).

    Reads the carry of :class:`repro_torch.core.equilibrium_batch._Chunk`
    as it stands (``dyn``, ``const``, ``scal``, and ``cap_lim`` = the
    capacities under the headroom) for the k sources ``src_order`` whose
    first ``n_avail`` (0-dim) are not parked, and evaluates every
    criterion of moving each source's shard row ``r`` (of ``r_cap``) to
    each device on the full ``(k, r_cap, n_dev)`` tensor, with the legality
    core's expressions in float64 (:func:`select_rows_masks`).  Returns

    * ``any`` (k · r_cap,) bool — the row has a legal destination, and its
      source is available;
    * ``dst`` (k · r_cap,) int32 — the emptiest legal destination, ties to
      the lowest index, 0 where none (:func:`masked_select_ref`);
    * ``cand_src`` (k,) bool — some row of the source has a pair that
      passes every criterion but the variance test (the source-bound
      certificates' test).
    """
    m = select_rows_masks(src_order, n_avail, cap_lim, dyn, const, scal)
    k, r_cap, n = m["valid"].shape
    any_row, dst = masked_select_ref(m["valid"].view(k * r_cap, n),
                                     dyn["util"])
    any_row = (any_row.view(k, r_cap) & m["avail"][:, None]).view(-1)
    return any_row, dst, m["cand"].flatten(1).any(dim=1)


NEG_INF = -1e30
#: the sliding window that never masks
NO_WINDOW = 1 << 30


def attention_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                   window: int, kv_limit) -> torch.Tensor:
    """(Tq, Tk) bool: key position below ``kv_limit``, not after the
    query position when causal, and inside the query's window."""
    mask = kv_pos[None, :] < kv_limit
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    return mask & (kv_pos[None, :] > q_pos[:, None] - window)


def flash_attention_online(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int | None = None,
                           cap: float | None = None,
                           scale: float | None = None,
                           kv_block: int = 512) -> torch.Tensor:
    """Online softmax over KV blocks with float32 state, the plain version
    of K2 that the model runs on the CPU: the reference's ``_fa_forward``
    without the lse it keeps for the backward pass.

    q (B, Tq, H, Dh), k/v (B, Tk, KV, Dh) → (B, Tq, H, Dh) in q's dtype;
    query head h reads KV head h // (H/KV)."""
    B, Tq, H, Dh = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    window = NO_WINDOW if window is None else window
    kv_block = min(kv_block, Tk)
    qf = q.float().reshape(B, Tq, KV, G, Dh) * scale
    q_pos = torch.arange(Tq, device=q.device)
    acc = torch.zeros((B, Tq, KV, G, Dh), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, Tq, KV, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    s = torch.zeros((B, Tq, KV, G), dtype=torch.float32, device=q.device)
    for k0 in range(0, Tk, kv_block):
        kblk = k[:, k0:k0 + kv_block].float()
        vblk = v[:, k0:k0 + kv_block].float()
        kv_pos = k0 + torch.arange(kblk.shape[1], device=q.device)
        mask = attention_mask(q_pos, kv_pos, causal, window, Tk)
        logits = torch.einsum("btkgd,bukd->btkgu", qf, kblk)
        if cap is not None:
            logits = cap * torch.tanh(logits / cap)
        logits = torch.where(mask[None, :, None, None, :], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        scale_old = torch.exp(m - m_new)
        s = s * scale_old + p.sum(dim=-1)
        acc = acc * scale_old[..., None] + torch.einsum("btkgu,bukd->btkgd",
                                                        p, vblk)
        m = m_new
    out = acc / torch.clamp(s, min=1e-30)[..., None]
    return out.reshape(B, Tq, H, Dh).to(q.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan, the plain version of K3 that the model runs on
    the CPU: within a chunk the quadratic (dual) form, across chunks a
    float32 state.

    x (B, T, H, P); dt (B, T, H) softplus'd step sizes; A (H,) negative
    decay rates; Bm/Cm (B, T, G, N), groups broadcast onto heads.  Returns
    (y (B, T, H, P) in x's dtype, final state (B, H, P, N) float32)."""
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    if T % chunk:
        raise ValueError(f"sequence {T} must be chunk-aligned ({chunk})")
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, T, chunk):
        xb = x[:, t0:t0 + chunk].float()                        # (B,Q,H,P)
        dtb = dt[:, t0:t0 + chunk].float()                      # (B,Q,H)
        Bb = Bm[:, t0:t0 + chunk].float().repeat_interleave(rep, dim=2)
        Cb = Cm[:, t0:t0 + chunk].float().repeat_interleave(rep, dim=2)
        acum = torch.cumsum(dtb * A[None, None, :], dim=1)      # inclusive
        # intra-chunk (dual quadratic form); the decay is selected, never
        # multiplied, above the diagonal, where its exponent is positive
        Lmat = acum[:, :, None, :] - acum[:, None, :, :]        # (B,Q,Q,H)
        Lmat = torch.where(tri[None, :, :, None], torch.exp(Lmat), 0.0)
        scores = torch.einsum("bthn,buhn->btuh", Cb, Bb) * Lmat
        scores = scores * dtb[:, None, :, :]                    # dt_u
        y_intra = torch.einsum("btuh,buhp->bthp", scores, xb)
        y_inter = torch.einsum("bthn,bhpn->bthp", Cb, state) \
            * torch.exp(acum)[..., None]
        total = acum[:, -1:, :]                                 # (B,1,H)
        decay_tail = torch.exp(total - acum)
        contrib = torch.einsum("buhn,buhp->bhpn",
                               Bb * (dtb * decay_tail)[..., None], xb)
        state = state * torch.exp(total[:, 0, :, None, None]) + contrib
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1).to(x.dtype), state


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        cap: float | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Full-softmax attention, plain version of K2.

    q (BH, Tq, Dh), k/v (BH, Tk, Dh) → (BH, Tq, Dh) in q's dtype.  The
    logits are float32, scaled after the product, tanh-capped before
    masking; masked logits are ``NEG_INF`` (never ``-inf``, so a row with
    no legal key averages v instead of turning NaN)."""
    Tq, Dh = q.shape[1], q.shape[2]
    Tk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    logits = torch.einsum("btd,bud->btu", q.float(), k.float()) * scale
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    q_pos = torch.arange(Tq, device=q.device)[:, None]
    k_pos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask[None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("btu,bud->btd", p, v.float()).to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-level SSD recurrence, plain version of K3.

    x (BH, T, P); dt (BH, T); A (BH,); Bm/Cm (BH, T, N) — the
    per-(batch·head) flattened layout.  Every operand is taken to float32
    (as JAX promotes a bf16 × f32 product).  Returns (y (BH, T, P) in x's
    dtype, final state (BH, P, N) float32)."""
    BH, T, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = Bm.float(), Cm.float()
    h = torch.zeros((BH, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dtf[:, t] * Af)
        contrib = torch.einsum("bn,bp->bpn", Bf[:, t] * dtf[:, t][:, None],
                               xf[:, t])
        h = h * decay[:, None, None] + contrib
        ys.append(torch.einsum("bn,bpn->bp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          cap: float | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """Model layout around :func:`flash_attention_ref`: q (B, T, H, Dh),
    k/v (B, Tk, KV, Dh) → (B, T, H, Dh); GQA k/v repeated to full heads."""
    B, T, H, Dh = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    out = flash_attention_ref(
        q.transpose(1, 2).reshape(B * H, T, Dh),
        k.transpose(1, 2).reshape(B * H, Tk, Dh),
        v.transpose(1, 2).reshape(B * H, Tk, Dh),
        causal=causal, window=window, cap=cap, scale=scale)
    return out.reshape(B, H, T, Dh).transpose(1, 2)


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """Model layout around :func:`ssd_scan_ref`: x (B, T, H, P),
    dt (B, T, H), A (H,), B/C (B, T, G, N) → y (B, T, H, P); groups
    repeated to heads."""
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Bh = Bm.repeat_interleave(H // G, dim=2)
    Ch = Cm.repeat_interleave(H // G, dim=2)
    y, _ = ssd_scan_ref(x.transpose(1, 2).reshape(B * H, T, P),
                        dt.transpose(1, 2).reshape(B * H, T), A.repeat(B),
                        Bh.transpose(1, 2).reshape(B * H, T, N),
                        Ch.transpose(1, 2).reshape(B * H, T, N))
    return y.reshape(B, H, T, P).transpose(1, 2)
