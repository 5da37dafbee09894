"""Plain PyTorch versions of the port's kernels.

What :mod:`.ops` runs on CPU tensors: K1 ``select_rows_ref`` (the
planner step's selection over ``select_rows_masks``, ending in
``masked_select_ref``), its lane form ``select_rows_lanes_ref``, its
window form ``select_rows_window_ref`` (the sharded engine's) and
``masked_select_ref``, K2 ``flash_attention_online`` (online softmax
over KV blocks) and K3 ``ssd_chunked`` (the chunk loop), the same
schedules as the reference model's own code.  The training backward of
attention, ``flash_attention_bwd_plain``, is the reference's
``_flash_bwd_impl``: plain on every device, as it is ``jnp`` outside any
Pallas kernel there.

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


#: the per-row registry arrays of the carry's ``const``, in the column
#: order of a packed record (:func:`pack_records`; ``sh_size`` last, as
#: its float64 bit pattern)
SH_FIELDS = ("sh_pg", "sh_pool", "sh_class", "sh_level", "sh_slot",
             "sh_sbase", "sh_scnt", "sh_size")


def pack_records(const: dict) -> torch.Tensor:
    """The eight registry arrays of ``const`` as one (rows, 8) int64
    tensor in :data:`SH_FIELDS` order, ``sh_size`` as its bit pattern."""
    cols = [const[f] for f in SH_FIELDS[:-1]]
    cols.append(const["sh_size"].view(torch.int64))
    return torch.stack(cols, dim=-1)


def unpack_records(rec: torch.Tensor) -> dict[str, torch.Tensor]:
    """A packed (..., 8) record tensor (:func:`pack_records`) as the dict
    of its :data:`SH_FIELDS` columns, ``sh_size`` float64 again."""
    out = {f: rec[..., i] for i, f in enumerate(SH_FIELDS[:-1])}
    out["sh_size"] = rec[..., -1].contiguous().view(torch.float64)
    return out


def _row_masks(src: torch.Tensor, rows: torch.Tensor, live: torch.Tensor,
               rec: dict, acting_t: torch.Tensor, crit: torch.Tensor,
               cap_lim: torch.Tensor, dyn: dict, const: dict,
               iota: torch.Tensor, at) -> dict[str, torch.Tensor]:
    """``pre`` and ``cand`` (k, R, m) of :func:`candidate_masks` over the
    devices ``iota`` (m,) (global ids; ``at(t)`` picks their columns of an
    (n,)-wide tensor) from the row side as given: ``live`` (k, R), the
    rows' records ``rec`` (:data:`SH_FIELDS` to (k, R) tensors), their
    PGs' acting sets ``acting_t`` (k, R, S) and the destination-count
    criterion at their pools ``crit`` (k, R, m)."""
    from ..core import legality
    d, c = dyn, const
    used, util = d["used"], d["util"]
    size = torch.where(rows >= 0, rec["sh_size"], 0.0)        # (k, R) f64
    lvl, slot = rec["sh_level"], rec["sh_slot"]
    sbase, scnt = rec["sh_sbase"], rec["sh_scnt"]

    # every criterion but the slots' and the variance test
    src_cc = src[:, None, None]                                # (k, 1, 1)
    u_s = util[src][:, None, None]
    pre = (live[..., None] & at(c["dev_in"]) & (iota != src_cc)
           & legality.before_source(at(util), u_s, iota, src_cc)
           & legality.class_ok(rec["sh_class"][..., None],
                               at(c["dev_class"]))
           & crit
           & legality.capacity_ok(at(used), at(cap_lim), size[..., None]))

    # not a member, failure domain free: from the acting table, all S
    # slots of each row's PG at once (the reference loops over the slots;
    # one (k, R, S, m) compare per test is the same OR).  Padded slots are
    # -1: never a member, never a peer.
    j = torch.arange(acting_t.shape[2], device=iota.device)
    lo, n_in = sbase[..., None], scnt[..., None]
    in_step = (lo <= j) & (lo + n_in > j) & (slot[..., None] != j)
    peer = torch.where(in_step, c["dev_domain"][lvl[..., None],
                                                acting_t.clamp(min=0)],
                       -1)                     # domain ids are >= 0
    member = (acting_t[..., None] == iota).any(dim=2)          # (k, R, m)
    dom = at(c["dev_domain"])[lvl]                             # (k, R, m)
    clash = (dom[:, :, None, :] == peer[..., None]).any(dim=2)
    return {"live": live, "pre": pre, "cand": pre & ~(member | clash),
            "size": size}


def candidate_masks(src: torch.Tensor, rows: torch.Tensor,
                    cap_lim: torch.Tensor, dyn: dict, const: dict,
                    scal: dict, devs: torch.Tensor | None = None
                    ) -> dict[str, torch.Tensor]:
    """Every criterion but the variance test of moving shard row
    ``rows[q, r]`` (-1: padding) off source ``src[q]`` onto each device of
    ``devs`` (m,) (None: all n, in order), on the carry as it stands:
    ``live`` (k, R) — a real row whose source-count criterion holds;
    ``pre`` (k, R, m) — live, and every criterion but the acting-slot
    tests; ``cand`` (k, R, m) — pre with the destination neither a member
    of the row's PG nor in a failure domain its rule step holds; ``size``
    (k, R) f64 — the row's bytes, 0 for padding.  The full evaluation
    feeds :func:`select_rows_masks`; two columns of it repair the batch
    engine's legality cache after a move."""
    # the legality core's package imports the engines, which import this
    # module: bind it at the first call
    from ..core import legality
    d, c, s = dyn, const, scal
    if devs is None:
        iota = torch.arange(d["used"].shape[0], device=d["used"].device)
        at = (lambda t: t)
    else:
        iota = devs
        at = (lambda t: t[..., devs])
    r = rows.clamp(min=0)               # -1 padding gathers row 0, masked
    rec = {f: c[f][r] for f in SH_FIELDS}
    pool = rec["sh_pool"]
    src_c = src[:, None]                                       # (k, 1)
    live = (rows >= 0) & legality.src_count_ok(
        d["pool_counts"][pool, src_c], c["ideal"][pool, src_c], s["slack"])
    crit = (d["dst_ok"][pool] if devs is None
            else d["dst_ok"][pool[..., None], devs])
    return _row_masks(src, rows, live, rec, d["acting"][rec["sh_pg"]], crit,
                      cap_lim, dyn, const, iota, at)


def _variance_ok(src_order: torch.Tensor, size: torch.Tensor, dyn: dict,
                 const: dict, scal: dict, at) -> torch.Tensor:
    """The exact variance acceptance (float64, reference operand order)
    of moving each row of ``size`` (k, R) off its source onto each device
    that ``at`` picks: (k, R, m)."""
    from ..core import legality
    d, c, s = dyn, const, scal
    used, util = d["used"], d["util"]
    return legality.variance_improves(
        used[src_order][:, None, None], at(used),
        c["cap"][src_order][:, None, None], at(c["cap"]),
        util[src_order][:, None, None], at(util), size[..., None],
        d["us"], d["usq"], s["n_f"], s["min_dvar"])


def select_rows_masks(src_order: torch.Tensor, n_avail: torch.Tensor,
                      cap_lim: torch.Tensor, dyn: dict, const: dict,
                      scal: dict, cache_ok: torch.Tensor | None = None,
                      hit_blk: torch.Tensor | None = None,
                      rb: int | None = None,
                      cache_out: torch.Tensor | None = None
                      ) -> dict[str, torch.Tensor]:
    """The masks behind :func:`select_rows_ref`, in the order K1's fused
    kernel tests them: ``live`` (k, R), ``pre`` and ``cand`` (k, R, n) of
    :func:`candidate_masks` for the k sources ``src_order`` and their
    rows; ``valid`` — cand and the variance test; ``avail`` (k,) — the
    source is not parked.

    With a cache (``cache_ok`` (k, R, n) bool, ``hit_blk`` (k, R / rb)
    bool, ``rb`` rows a block): the candidate mask of a row in a hit
    block is read from ``cache_ok``, and every other row's fresh one is
    written into ``cache_out`` (default ``cache_ok``), in place; the
    variance test runs on ``cand`` as read."""
    k = src_order.shape[0]
    m = candidate_masks(src_order, dyn["rows_on"][src_order], cap_lim, dyn,
                        const, scal)
    if cache_ok is not None:
        hit = hit_blk.repeat_interleave(rb, dim=1)[..., None]  # (k, R, 1)
        out = cache_ok if cache_out is None else cache_out
        fresh = m["cand"]
        m["cand"] = torch.where(hit, cache_ok, fresh)
        out.copy_(torch.where(hit, out, fresh))

    m["valid"] = m["cand"] & _variance_ok(src_order, m["size"], dyn, const,
                                          scal, lambda t: t)
    m["avail"] = torch.arange(k, device=src_order.device) < n_avail
    return m


def select_rows_ref(src_order: torch.Tensor, n_avail: torch.Tensor,
                    cap_lim: torch.Tensor, dyn: dict, const: dict,
                    scal: dict, *, cache_ok: torch.Tensor | None = None,
                    hit_blk: torch.Tensor | None = None,
                    rb: int | None = None,
                    cache_out: torch.Tensor | None = None,
                    cand_row: bool = False) -> tuple[torch.Tensor, ...]:
    """The batched planner step's selection, plain version of K1's fused
    kernel (:func:`repro_torch.kernels.select_move.select_rows_fwd`).

    Reads the carry of :class:`repro_torch.core.equilibrium_batch._Chunk`
    as it stands (``dyn``, ``const``, ``scal``, and ``cap_lim`` = the
    capacities under the headroom) for the k sources ``src_order`` whose
    first ``n_avail`` (0-dim) are not parked, and evaluates every
    criterion of moving each source's shard row ``r`` (of ``r_cap``) to
    each device on the full ``(k, r_cap, n_dev)`` tensor, with the legality
    core's expressions in float64 (:func:`select_rows_masks`, which also
    says how the optional legality cache ``cache_ok`` / ``hit_blk`` /
    ``rb`` / ``cache_out`` is read and written).  Returns

    * ``any`` (k · r_cap,) bool — the row has a legal destination, and its
      source is available;
    * ``dst`` (k · r_cap,) int32 — the emptiest legal destination, ties to
      the lowest index, 0 where none (:func:`masked_select_ref`);
    * ``cand_src`` (k,) bool — some row of the source has a pair that
      passes every criterion but the variance test (the source-bound
      certificates' test);
    * with ``cand_row=True``, ``cand_row`` (k, r_cap) bool — the same per
      row (False for padding rows).
    """
    m = select_rows_masks(src_order, n_avail, cap_lim, dyn, const, scal,
                          cache_ok, hit_blk, rb, cache_out)
    k, r_cap, n = m["valid"].shape
    any_row, dst = masked_select_ref(m["valid"].view(k * r_cap, n),
                                     dyn["util"])
    any_row = (any_row.view(k, r_cap) & m["avail"][:, None]).view(-1)
    per_row = m["cand"].any(dim=2)
    out = (any_row, dst, per_row.any(dim=1))
    return (*out, per_row) if cand_row else out


def select_rows_window_ref(src_order: torch.Tensor, n_avail: torch.Tensor,
                           rows_k: torch.Tensor, rec: torch.Tensor,
                           act_k: torch.Tensor, src_ok: torch.Tensor,
                           cap_lim: torch.Tensor, dyn: dict, const: dict,
                           scal: dict, *, base: int,
                           cand_row: bool = False
                           ) -> tuple[torch.Tensor, ...]:
    """:func:`select_rows_ref` restricted to one rank's window of the
    destination axis, the global devices ``[base, base + n_local)``: the
    plain version of K1's window form
    (:class:`repro_torch.kernels.select_move.SelectRowsWindow`), which the
    sharded engine (:mod:`repro_torch.core.shard`) launches once a step on
    each rank.

    Destination-side data comes from the rank's own block, ``dyn["dst_ok"]``
    (P, n_local), and from the replicated (n,) vectors ``used``, ``util``
    (``dyn``), ``cap``, ``dev_class``, ``dev_in``, ``dev_domain`` (L, n)
    (``const``) and ``cap_lim``; ``dyn["us"]``, ``dyn["usq"]`` and
    ``scal["n_f"]``, ``scal["min_dvar"]`` are the variance test's.  Source-
    and row-side data comes from what the engine gathered for the step
    from the ranks that own it: the k sources ``src_order`` (global ids,
    the first ``n_avail`` available), their rows ``rows_k`` (k, R) (-1
    padded), those rows' packed records ``rec`` (k, R, 8)
    (:func:`pack_records`' columns), their PGs' acting sets ``act_k``
    (k, R, S) and the source-count criterion at each row's pool
    ``src_ok`` (k, R).  Returns what :func:`select_rows_ref` returns for
    the window alone: ``any`` (k · R,), ``dst`` (k · R,) int32 — a global
    index, ``base`` where the row has no legal destination in the window
    — ``cand_src`` (k,) and, with ``cand_row``, ``cand_row`` (k, R)."""
    n_local = dyn["dst_ok"].shape[1]
    k, R = rows_k.shape
    iota = base + torch.arange(n_local, device=rows_k.device)

    def at(t):
        return t[..., base:base + n_local]

    fields = unpack_records(rec)
    crit = dyn["dst_ok"][fields["sh_pool"]]                  # (k, R, m)
    m = _row_masks(src_order, rows_k, (rows_k >= 0) & src_ok, fields, act_k,
                   crit, cap_lim, dyn, const, iota, at)
    valid = m["cand"] & _variance_ok(src_order, m["size"], dyn, const, scal,
                                     at)
    any_row, dst = masked_select_ref(valid.view(k * R, n_local),
                                     at(dyn["util"]))
    avail = torch.arange(k, device=rows_k.device) < n_avail
    any_row = (any_row.view(k, R) & avail[:, None]).view(-1)
    per_row = m["cand"].any(dim=2)
    out = (any_row, (dst + base).to(torch.int32), per_row.any(dim=1))
    return (*out, per_row) if cand_row else out


def lane_view(d: dict, lane: int) -> dict:
    """Lane ``lane`` of a carry dict stacked on a leading lane axis: each
    tensor's slice, a view."""
    return {key: t[lane] for key, t in d.items()}


def select_rows_lanes_ref(src_order: torch.Tensor, n_avail: torch.Tensor,
                          cap_lim: torch.Tensor, dyn: dict, const: dict,
                          scal: dict, *, cand_row: bool = False
                          ) -> tuple[torch.Tensor, ...]:
    """:func:`select_rows_ref` on carries of one shape stacked on a
    leading lane axis (the fleet planner's bucket), plain version of K1's
    lane launch.  Every tensor of ``dyn``, ``const``, ``scal`` and
    ``cap_lim`` carries the lanes first (a scalar one per lane),
    ``src_order`` is (lanes, k) and ``n_avail`` (lanes,); each output is
    :func:`select_rows_ref`'s with the leading lane axis.  A loop over
    the lanes, each on its own views, so no lane reads another's data."""
    outs = [select_rows_ref(src_order[b], n_avail[b], cap_lim[b],
                            lane_view(dyn, b), lane_view(const, b),
                            lane_view(scal, b), cand_row=cand_row)
            for b in range(src_order.shape[0])]
    return tuple(torch.stack(col) for col in zip(*outs))


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
                           kv_block: int = 512, with_lse: bool = False):
    """Online softmax over KV blocks with float32 state, the plain version
    of K2 that the model runs on the CPU: the reference's ``_fa_forward``.

    q (B, Tq, H, Dh), k/v (B, Tk, KV, Dh) → (B, Tq, H, Dh) in q's dtype;
    query head h reads KV head h // (H/KV).  With ``with_lse``, →
    (out (B, Tq, H, Dh) float32, before the cast; lse (B, H, Tq) float32,
    ``m + log(s)``), the residuals the training backward reads."""
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
    s = torch.clamp(s, min=1e-30)
    out = (acc / s[..., None]).reshape(B, Tq, H, Dh)
    if with_lse:
        lse = (m + torch.log(s)).reshape(B, Tq, H).transpose(1, 2)
        return out, lse.contiguous()
    return out.to(q.dtype)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True,
                              window: int | None = None,
                              cap: float | None = None,
                              scale: float | None = None,
                              kv_block: int = 512
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Attention's backward pass from the forward's residuals, the
    reference's ``_flash_bwd_impl`` (``src/repro/models/layers.py:175-208``):
    per KV block, the probabilities recomputed from the saved ``lse``,
    ``p = exp(capped − lse)``; ``ds = p (dp − delta)`` with
    ``delta = Σ dout·out``, times the softcap's derivative ``1 − t²``
    (t the masked capped logit over the cap), 0 where masked.

    Model layout: q/out/dout (B, Tq, H, Dh), k/v (B, Tk, KV, Dh), lse
    (B, H, Tq) float32 → (dq, dk, dv) in q's, k's and v's dtypes; dk and
    dv sum each KV head's H/KV query heads.  Every product is float32."""
    B, Tq, H, Dh = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    window = NO_WINDOW if window is None else window
    kv_block = min(kv_block, Tk)
    qf = q.float().reshape(B, Tq, KV, G, Dh) * scale
    do = dout.float().reshape(B, Tq, KV, G, Dh)
    delta = (do * out.float().reshape(B, Tq, KV, G, Dh)).sum(dim=-1)
    lse = lse.transpose(1, 2).reshape(B, Tq, KV, G)[..., None]
    q_pos = torch.arange(Tq, device=q.device)
    dq = torch.zeros((B, Tq, KV, G, Dh), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for k0 in range(0, Tk, kv_block):
        kblk = k[:, k0:k0 + kv_block].float()
        vblk = v[:, k0:k0 + kv_block].float()
        kv_pos = k0 + torch.arange(kblk.shape[1], device=q.device)
        mask = attention_mask(q_pos, kv_pos, causal, window,
                              Tk)[None, :, None, None, :]
        capped = torch.einsum("btkgd,bukd->btkgu", qf, kblk)
        if cap is not None:
            capped = cap * torch.tanh(capped / cap)
        capped = torch.where(mask, capped, NEG_INF)
        p = torch.exp(capped - lse)
        dvs.append(torch.einsum("btkgu,btkgd->bukd", p, do))
        ds = p * (torch.einsum("btkgd,bukd->btkgu", do, vblk)
                  - delta[..., None])
        if cap is not None:                                 # d softcap
            t = capped / cap
            ds = ds * (1.0 - t * t)
        ds = torch.where(mask, ds, 0.0)
        dq = dq + torch.einsum("btkgu,bukd->btkgd", ds, kblk)
        dks.append(torch.einsum("btkgu,btkgd->bukd", ds, qf))
    return ((dq * scale).reshape(B, Tq, H, Dh).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


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
        # intra-chunk (dual quadratic form).  Above the diagonal the
        # exponent is positive and overflows at full width (mamba2: A -16,
        # dt 0.1, 128 tokens), so it is masked to -inf before the exp:
        # the same values as the reference's where(tri, exp(L), 0), whose
        # gradient there is 0 · inf = NaN (src/repro/models/ssm.py:116-118)
        Lmat = acum[:, :, None, :] - acum[:, None, :, :]        # (B,Q,Q,H)
        Lmat = torch.exp(torch.where(tri[None, :, :, None], Lmat,
                                     float("-inf")))
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
