"""Plain PyTorch versions of K10b, the SSD chunk scan's backward.

* ``ssd_chunk_bwd_ref``: the counterpart of
  ``repro/kernels/ssd_chunk/bwd.py``: walk the chunks back to front with
  the (P, S) state cotangent ``dh`` carried (zero at the end: the forward
  discards its final state), and per chunk pull back ``_ssd_step`` from
  the saved carry-in, written out;
* ``ssd_chunk_bwd_parallel``: the same pull-back in the order
  ``csrc/ssd_chunk_bwd.cu`` computes it: each chunk's local carry
  cotangent at once, the reverse pass, then per (batch, chunk) the heads'
  sums.

With cum = L dt (L the lower triangle of ones), D = exp(cum_i - cum_j)
[j <= i] (``ref.chunk_terms``), G = c b^T, M = G o D, seg = exp(cum_last
- cum), and the cotangents gy (C, P) of y and gh (P, S) of the carry-out:

    dx    = M^T gy + seg o (b gh^T)
    dM    = gy x^T
    dc    = (dM o D) b + exp(cum) o (gy h)
    db    = (dM o D)^T c + seg o (x gh)
    dh_in = exp(cum_last) gh + (exp(cum) o gy)^T c
    dcum  = rows(E) - cols(E) + exp(cum) o sum_s c o (gy h),  E = dM o G o D,
            plus exp(cum_last) sum(gh o h) + sum_j seg_j dseg_j at the last
            row and -seg o dseg everywhere, dseg = sum_s (x gh) o b
    ddt   = L^T dcum (a reverse inclusive cumsum)

db and dc are summed over the heads that share b and c: (B, N, S).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_chunk.ref import (chunk_terms, chunked,
                                               per_row, state_pass)


def ssd_step_vjp(h, x, dt, b, c, gy, gh):
    """Pull back one chunk: (dh_in, dx, ddt, db, dc) for the cotangents
    gy (BH, C, P) of y and gh (BH, P, S) of the carry-out."""
    cum, _, decay, ecum, seg = chunk_terms(dt)
    g = c @ b.transpose(1, 2)
    dmt = gy @ x.transpose(1, 2)
    dmd = dmt * decay
    dx = (g * decay).transpose(1, 2) @ gy + seg * (b @ gh.transpose(1, 2))
    xgh = x @ gh
    db = dmd.transpose(1, 2) @ c + seg * xgh
    gyh = gy @ h
    dc = dmd @ b + ecum * gyh
    dh_in = torch.exp(cum[:, -1:]) * gh + (ecum * gy).transpose(1, 2) @ c
    e = dmt * g * decay
    dcum = (e.sum(-1) - e.sum(-2))[..., None] + ecum * (c * gyh).sum(
        -1, keepdim=True)
    dseg = (xgh * b).sum(-1, keepdim=True)
    dcum = dcum - seg * dseg
    last = (torch.exp(cum[:, -1, 0]) * (gh * h).sum((-2, -1))
            + (seg * dseg).sum((-2, -1)))
    dcum[:, -1, 0] += last
    ddt = dcum.flip(1).cumsum(1).flip(1)
    return dh_in, dx, ddt, db, dc


def head_sum(d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-row gradients d (BH, N, S) summed over the heads that share the
    b or c ``t`` was: (B, N, S) (``t`` (BH, N, S) keeps one head a row)."""
    bsz = t.shape[0]
    return d.reshape(bsz, d.shape[0] // bsz, *d.shape[1:]).sum(1)


def ssd_chunk_bwd_ref(x, dta, b, c, hins, g, *, chunk: int):
    """Gradients of ``ssd_chunk_chunked``'s y w.r.t. (x, dta, b, c) for the
    cotangent g (BH, N, P), from the saved carry-ins hins (BH, N / chunk,
    P, S).  db and dc are (B, N, S), summed over each batch row's heads."""
    bh, n, _ = x.shape
    b4, c4 = b, c
    b, c = per_row(b, bh).float(), per_row(c, bh).float()
    xf, af, gf = x.float(), dta.float(), g.float()
    dh = torch.zeros_like(hins[:, 0])
    dx, ddt, db, dc = (torch.empty_like(t) for t in (xf, af, b, c))
    for ci in reversed(range(n // chunk)):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        dh, dx[:, sl], ddt[:, sl], db[:, sl], dc[:, sl] = ssd_step_vjp(
            hins[:, ci].float(), xf[:, sl], af[:, sl], b[:, sl], c[:, sl],
            gf[:, sl], dh)
    return (dx.to(x.dtype), ddt.to(dta.dtype), head_sum(db, b4),
            head_sum(dc, c4))


def ssd_chunk_bwd_parallel(x, dta, b, c, hins, g, *, chunk: int):
    """``ssd_chunk_bwd_ref`` computed as ``csrc/ssd_chunk_bwd.cu`` does:
    the local carry cotangents (exp(cum) o gy)^T c, the reverse pass for
    each chunk's gh, G = c b^T once per (batch, chunk), W = sum over the
    heads of dM o D, db = W^T c + sum_h seg o (x gh), dc = W b + sum_h
    exp(cum) o (gy h); dx and ddt per head.  Returns (dx, ddt, db, dc)
    with db and dc (B, N, S)."""
    bh, n, p = x.shape
    xs, dt, bs, cs = chunked(x, dta, b, c, chunk)
    bsz, heads, nc = xs.shape[:3]
    gy = g.float().reshape(xs.shape)
    h = hins.float().reshape(bsz, heads, nc, p, -1)
    cum, _, decay, ecum, seg = chunk_terms(dt)
    last = torch.exp(cum[..., -1, 0])
    local = torch.einsum("bhcip,bcis->bhcps", gy * ecum, cs)
    gh = state_pass(local, last, reverse=True)
    gram = torch.einsum("bcis,bcjs->bcij", cs, bs)
    bgh = torch.einsum("bcjs,bhcps->bhcjp", bs, gh)
    dx = (torch.einsum("bhcij,bhcip->bhcjp", gram[:, None] * decay, gy)
          + seg * bgh)
    dseg = (xs * bgh).sum(-1, keepdim=True)
    dmd = torch.einsum("bhcip,bhcjp->bhcij", gy, xs) * decay
    w = dmd.sum(1)
    e = dmd * gram[:, None]
    gyh = torch.einsum("bhcip,bhcps->bhcis", gy, h)
    db = (torch.einsum("bcij,bcis->bcjs", w, cs)
          + torch.einsum("bhcjp,bhcps->bcjs", xs * seg, gh))
    dc = torch.einsum("bcij,bcjs->bcis", w, bs) + (ecum * gyh).sum(1)
    dcum = ((e.sum(-1) - e.sum(-2))[..., None]
            + ecum * (cs[:, None] * gyh).sum(-1, keepdim=True) - seg * dseg)
    dcum[..., -1, 0] += (last * (gh * h).sum((-2, -1))
                         + (seg * dseg).sum((-2, -1)))
    ddt = dcum.flip(-2).cumsum(-2).flip(-2)
    s = bs.shape[-1]
    return (dx.reshape(bh, n, p), ddt.reshape(bh, n, 1),
            db.reshape(bsz, n, s), dc.reshape(bsz, n, s))
