"""Plain PyTorch versions of K10a, the SSD chunk scan.

* ``ssd_chunk_ref``: the sequential recurrence, the counterpart of
  ``repro/kernels/ssd_chunk/ref.py::ssd_chunk_ref`` -- the oracle;
* ``ssd_chunk_chunked``: the kernel's arithmetic in PyTorch, chunk by
  chunk as ``repro/kernels/ssd_chunk/ssd_chunk.py::_ssd_step`` computes
  it, returning y and each chunk's carry-in; differentiable by autograd
  (the plain path's training route and the oracle of K10b on the card).

Operands: x (BH, N, P) pre-scaled by dt; dta (BH, N, 1) = dt * A, the log
decays; b and c (BH, N, S), or (B, H, N, S) views shared across heads
(``bmat[:, None].expand(B, H, N, S)``); all fp32.
"""
from __future__ import annotations

import torch


def flat_bc(t: torch.Tensor) -> torch.Tensor:
    """(BH, N, S) from a (BH, N, S) tensor or a (B, H, N, S) view."""
    return t.reshape(-1, *t.shape[-2:]) if t.ndim == 4 else t


def ssd_chunk_ref(x, dta, b, c):
    """h_t = exp(dta_t) h_{t-1} + x_t outer b_t;  y_t = h_t @ c_t.
    Returns y (BH, N, P) in x's dtype."""
    b, c = flat_bc(b).float(), flat_bc(c).float()
    bh, n, p = x.shape
    h = torch.zeros((bh, p, b.shape[-1]), dtype=torch.float32,
                    device=x.device)
    xf, af = x.float(), dta.float()
    ys = []
    for t in range(n):
        h = h * torch.exp(af[:, t])[:, :, None] + torch.einsum(
            "bp,bs->bps", xf[:, t], b[:, t])
        ys.append(torch.einsum("bps,bs->bp", h, c[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


def chunk_terms(dt: torch.Tensor):
    """The in-chunk decay terms of one chunk of log decays dt (BH, C, 1):
    cum (inclusive cumsum, (BH, C, 1)), the lower triangle ``tri`` and the
    decay D = exp(cum_i - cum_j) on it, 0 above (BH, C, C), exp(cum) and
    seg = exp(cum_last - cum) (both (BH, C, 1)).

    The difference is masked before exp, so the upper triangle never
    overflows (inf * 0 would be NaN).  The reference clamps it with
    min(., 0) instead: the same values, since cum never rises, but a
    derivative of 1/2 where rounding makes cum_i == cum_j for j < i (a
    decay below the spacing of cum), which depends on the order the
    cumsum was summed in.  Masked, the derivative is 1 on the whole lower
    triangle whatever that order.
    """
    cum = torch.cumsum(dt, dim=1)
    c = dt.shape[1]
    tri = torch.ones((c, c), dtype=dt.dtype, device=dt.device).tril()
    diff = cum - cum.transpose(1, 2)  # cum_i - cum_j
    decay = torch.exp(torch.where(tri > 0, diff, 0.0)) * tri
    return cum, tri, decay, torch.exp(cum), torch.exp(cum[:, -1:] - cum)


def ssd_step(h, x, dt, b, c):
    """One chunk: h (BH, P, S), x (BH, C, P), dt (BH, C, 1), b/c (BH, C,
    S) -> (h_out, y (BH, C, P)); ``_ssd_step``'s arithmetic."""
    cum, _, decay, ecum, seg = chunk_terms(dt)
    scores = c @ b.transpose(1, 2)  # (C, C): c_i . b_j
    intra = (scores * decay) @ x
    inter = (c @ h.transpose(1, 2)) * ecum
    h_new = h * torch.exp(cum[:, -1:]) + (x * seg).transpose(1, 2) @ b
    return h_new, intra + inter


def ssd_chunk_chunked(x, dta, b, c, chunk: int):
    """K10a's arithmetic: y (BH, N, P) and the carry-in of every chunk,
    hins (BH, N / chunk, P, S), fp32."""
    b, c = flat_bc(b).float(), flat_bc(c).float()
    bh, n, p = x.shape
    if n % chunk:
        raise ValueError(f"N = {n} is not a multiple of chunk = {chunk}")
    h = torch.zeros((bh, p, b.shape[-1]), dtype=torch.float32,
                    device=x.device)
    xf, af = x.float(), dta.float()
    ys, hins = [], []
    for t0 in range(0, n, chunk):
        sl = slice(t0, t0 + chunk)
        hins.append(h)
        h, y = ssd_step(h, xf[:, sl], af[:, sl], b[:, sl], c[:, sl])
        ys.append(y)
    return torch.cat(ys, dim=1), torch.stack(hins, dim=1)
