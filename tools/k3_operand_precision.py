#!/usr/bin/env python
"""Why the tensor-core K3 (``src/repro_torch/csrc/ssd_scan.cu``) hands its
float32 operands to the tensor cores as two bf16 terms.

A float64 model of the kernel's arithmetic (G 1, P = N = 64, chunk 128,
bf16 x, B and C, float32 dt): chunk states S_c = x^T W with W = B dt
exp(total - acum), the hand-off s_in[c] = s_in[c-1] exp(total) + S_{c-1},
and y = exp(acum) C s_in^T + (C B^T * decay * dt) x.  The float32
operands of those products (W, the decayed scores, s_in) go in as the
kernel could hand them over: exact (``float32``), one bf16 term
(``bf16``), or hi = bf16(v) plus lo = bf16(v - hi) (``split``).  For each,
it prints the worst relative L2 error of a (token, head) row of y,
rounded to bf16 as the kernel stores it, against the exact scan, on the
model's dt and A ramps and on the reference suite's draws.  The card's
gate for that error is 1e-2.

    PYTHONPATH=src python tools/k3_operand_precision.py [--T 2048 --H 16]

CPU only, a few seconds; imports torch and the port's ``ssd_ramps``.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.models.lm import ssd_ramps


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def inputs(T: int, H: int, ramp: bool, seed: int):
    """x, dt, A, B, C in float64 holding bf16 x, B, C and float32 dt, A."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((1, T, H, 64), generator=g)
    if ramp:
        dt_h, A = ssd_ramps(H)
        dt = torch.nn.functional.softplus(
            torch.log(torch.expm1(dt_h))
            + 0.5 * torch.randn((1, T, H), generator=g))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((1, T, H), generator=g) - 1)
        A = -torch.exp(torch.randn((H,), generator=g) * 0.3)
    Bm = torch.randn((1, T, 1, 64), generator=g) * 0.5
    Cm = torch.randn((1, T, 1, 64), generator=g) * 0.5
    return (_bf16(x).double(), dt.double(), A.double(), _bf16(Bm).double(),
            _bf16(Cm).double())


def scan_model(x, dt, A, Bm, Cm, chunk: int, operands: str):
    """The tensor-core K3's schedule in float64 with its float32 operands
    given to the products as ``operands`` says."""
    def terms(v):
        if operands == "float32":
            return [v]
        hi = _bf16(v)
        return [hi] if operands == "bf16" else [hi, _bf16(v - hi)]
    B, T, H, P = x.shape
    nc = T // chunk
    xs = x.view(B, nc, chunk, H, P)
    Bs, Cs = Bm.view(B, nc, chunk, -1), Cm.view(B, nc, chunk, -1)
    d = dt.view(B, nc, chunk, H)
    acum = torch.cumsum(d * A, dim=2)
    total = acum[:, :, -1]
    W = Bs[:, :, :, None, :] * (d * torch.exp(total[:, :, None] - acum)
                                )[..., None]
    S = sum(torch.einsum("bcuhp,bcuhn->bchpn", xs, w) for w in terms(W))
    s_in, run = torch.zeros_like(S), torch.zeros_like(S[:, 0])
    for c in range(nc):
        s_in[:, c] = run
        run = run * torch.exp(total[:, c])[..., None, None] + S[:, c]
    scores = torch.einsum("bctn,bcun->bctu", Cs, Bs)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    decay = torch.where(tri[None, None, :, :, None],
                        torch.exp(acum[:, :, :, None] - acum[:, :, None]),
                        0.0)
    M = decay * scores[..., None] * d[:, :, None]
    y = sum(torch.einsum("bctuh,bcuhp->bcthp", m, xs) for m in terms(M))
    y = y + sum(torch.einsum("bctn,bchpn->bcthp", Cs, s) for s in
                terms(s_in)) * torch.exp(acum)[..., None]
    return y.reshape(B, T, H, P)


def row_errors(T: int, H: int, ramp: bool, seed: int) -> dict[str, float]:
    ins = inputs(T, H, ramp, seed)
    exact = scan_model(*ins, 128, "float32")
    out = {}
    for operands in ("float32", "bf16", "split"):
        got = _bf16(scan_model(*ins, 128, operands).float()).double()
        row = (got - exact).norm(dim=-1) / exact.norm(dim=-1).clamp_min(1e-6)
        out[operands] = float(row.max())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", type=int, default=2048)
    ap.add_argument("--H", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    a = ap.parse_args()
    for ramp in (True, False):
        print(json.dumps({"inputs": "ramps" if ramp else "reference draws",
                          "T": a.T, "H": a.H, "worst_row_rel_l2":
                          row_errors(a.T, a.H, ramp, a.seed)}))


if __name__ == "__main__":
    main()
