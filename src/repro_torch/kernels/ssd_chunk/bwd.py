"""Plain PyTorch version of K10b, the SSD chunk scan's backward.

The counterpart of ``repro/kernels/ssd_chunk/bwd.py``: walk the chunks
back to front with the (P, S) state cotangent ``dh`` carried (zero at the
end: the forward discards its final state), and per chunk pull back
``_ssd_step`` from the saved carry-in.  The pull-back is written out, as
``csrc/ssd_chunk_bwd.cu`` computes it.  With cum = L dt (L the lower
triangle of ones), D = exp(cum_i - cum_j) [j <= i] (``ref.chunk_terms``),
G = c b^T, M = G o D, seg = exp(cum_last - cum), and the cotangents gy
(C, P) of y and gh (P, S) of the carry-out:

    dx    = M^T gy + seg o (b gh^T)
    dM    = gy x^T
    dc    = (dM o D) b + exp(cum) o (gy h)
    db    = (dM o D)^T c + seg o (x gh)
    dh_in = exp(cum_last) gh + (exp(cum) o gy)^T c
    dcum  = rows(E) - cols(E) + exp(cum) o sum_s c o (gy h),  E = dM o G o D,
            plus exp(cum_last) sum(gh o h) + sum_j seg_j dseg_j at the last
            row and -seg o dseg everywhere, dseg = sum_s (x gh) o b
    ddt   = L^T dcum (a reverse inclusive cumsum)
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_chunk.ref import chunk_terms, flat_bc


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


def ssd_chunk_bwd_ref(x, dta, b, c, hins, g, *, chunk: int):
    """Gradients of ``ssd_chunk_chunked``'s y w.r.t. (x, dta, b, c) for the
    cotangent g (BH, N, P), from the saved carry-ins hins (BH, N / chunk,
    P, S).  db and dc come per (b.h) row, shaped like b and c."""
    b4, c4 = b, c
    b, c = flat_bc(b).float(), flat_bc(c).float()
    xf, af, gf = x.float(), dta.float(), g.float()
    n = x.shape[1]
    dh = torch.zeros_like(hins[:, 0])
    dx, ddt, db, dc = (torch.empty_like(t) for t in (xf, af, b, c))
    for ci in reversed(range(n // chunk)):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        dh, dx[:, sl], ddt[:, sl], db[:, sl], dc[:, sl] = ssd_step_vjp(
            hins[:, ci].float(), xf[:, sl], af[:, sl], b[:, sl], c[:, sl],
            gf[:, sl], dh)
    return (dx.to(x.dtype), ddt.to(dta.dtype), db.reshape(b4.shape),
            dc.reshape(c4.shape))
