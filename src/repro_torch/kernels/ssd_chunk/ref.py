"""Plain PyTorch versions of K10a, the SSD chunk scan.

* ``ssd_chunk_ref``: the sequential recurrence, the counterpart of
  ``repro/kernels/ssd_chunk/ref.py::ssd_chunk_ref`` -- the oracle;
* ``ssd_chunk_chunked``: the kernel's arithmetic in PyTorch, chunk by
  chunk as ``repro/kernels/ssd_chunk/ssd_chunk.py::_ssd_step`` computes
  it, returning y and each chunk's carry-in; differentiable by autograd
  (the plain path's training route and the oracle of K10b on the card);
* ``ssd_chunk_parallel``: the same function in the order
  ``csrc/ssd_chunk.cu`` computes it: every chunk's local state at once,
  the state pass over the chunks, then c b^T once per (batch, chunk) and
  each head's outputs.

Operands: x (BH, N, P) pre-scaled by dt; dta (BH, N, 1) = dt * A, the log
decays; b and c (B, N, S), shared by the BH / B heads of each batch row
(a (BH, N, S) tensor is B = BH, one head each), or (B, H, N, S) views;
all fp32.
"""
from __future__ import annotations

import torch


def per_row(t: torch.Tensor, bh: int) -> torch.Tensor:
    """(BH, N, S) rows of b or c: from (BH, N, S), from (B, N, S) shared
    by the BH / B heads of each batch row, or from a (B, H, N, S) view."""
    if t.ndim == 4:
        return t.reshape(-1, *t.shape[-2:])
    if t.shape[0] == bh:
        return t
    heads = bh // t.shape[0]
    return t[:, None].expand(t.shape[0], heads, *t.shape[1:]).reshape(
        bh, *t.shape[1:])


def shared_rows(t: torch.Tensor) -> torch.Tensor:
    """The (B, N, S) rows of b or c that the heads share (head 0 of a
    (B, H, N, S) view)."""
    return t[:, 0] if t.ndim == 4 else t


def ssd_chunk_ref(x, dta, b, c):
    """h_t = exp(dta_t) h_{t-1} + x_t outer b_t;  y_t = h_t @ c_t.
    Returns y (BH, N, P) in x's dtype."""
    bh, n, p = x.shape
    b, c = per_row(b, bh).float(), per_row(c, bh).float()
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
    """The in-chunk decay terms of chunks of log decays dt (..., C, 1):
    cum (inclusive cumsum, (..., C, 1)), the lower triangle ``tri`` and
    the decay D = exp(cum_i - cum_j) on it, 0 above (..., C, C), exp(cum)
    and seg = exp(cum_last - cum) (both (..., C, 1)).

    The difference is masked before exp, so the upper triangle never
    overflows (inf * 0 would be NaN).  The reference clamps it with
    min(., 0) instead: the same values, since cum never rises, but a
    derivative of 1/2 where rounding makes cum_i == cum_j for j < i (a
    decay below the spacing of cum), which depends on the order the
    cumsum was summed in.  Masked, the derivative is 1 on the whole lower
    triangle whatever that order.
    """
    cum = torch.cumsum(dt, dim=-2)
    c = dt.shape[-2]
    tri = torch.ones((c, c), dtype=dt.dtype, device=dt.device).tril()
    diff = cum - cum.transpose(-1, -2)  # cum_i - cum_j
    decay = torch.exp(torch.where(tri > 0, diff, 0.0)) * tri
    return cum, tri, decay, torch.exp(cum), torch.exp(cum[..., -1:, :] - cum)


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
    bh, n, p = x.shape
    b, c = per_row(b, bh).float(), per_row(c, bh).float()
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


def chunked(x, dta, b, c, chunk: int):
    """Operands split by chunk, fp32: x (B, H, nc, C, P), dt (B, H, nc, C,
    1), b and c (B, nc, C, S) as the heads share them."""
    bh, n, p = x.shape
    b, c = shared_rows(b).float(), shared_rows(c).float()
    bsz, s = b.shape[0], b.shape[-1]
    heads, nc = bh // bsz, n // chunk
    return (x.float().reshape(bsz, heads, nc, chunk, p),
            dta.float().reshape(bsz, heads, nc, chunk, 1),
            b.reshape(bsz, nc, chunk, s), c.reshape(bsz, nc, chunk, s))


def state_pass(local, last, reverse: bool = False):
    """The pass over the chunks (dim 2) of local states (B, H, nc, P, S)
    with decays last = exp(cum_last) (B, H, nc): each chunk's carry-in,
    h <- last h + local in chunk order from zero, or (``reverse``) each
    chunk's carry-out cotangent, g <- last g + local from the last chunk,
    zero for the last."""
    out = torch.empty_like(local)
    h = torch.zeros_like(local[:, :, 0])
    order = reversed(range(local.shape[2])) if reverse else range(
        local.shape[2])
    for ci in order:
        out[:, :, ci] = h
        h = last[:, :, ci, None, None] * h + local[:, :, ci]
    return out


def ssd_chunk_parallel(x, dta, b, c, chunk: int):
    """``ssd_chunk_chunked`` computed as ``csrc/ssd_chunk.cu`` does:
    (a) each (row, chunk)'s local state (x o seg)^T b, (b) the state pass,
    (c) G = c b^T once per (batch, chunk) and per head y = (G o D) x +
    exp(cum) o (c h^T).  Returns y (BH, N, P) and hins (BH, nc, P, S)."""
    bh, n, p = x.shape
    if n % chunk:
        raise ValueError(f"N = {n} is not a multiple of chunk = {chunk}")
    xs, dt, bs, cs = chunked(x, dta, b, c, chunk)
    _, _, decay, ecum, seg = chunk_terms(dt)
    last = torch.exp(dt.cumsum(-2)[..., -1, 0])
    local = torch.einsum("bhcjp,bcjs->bhcps", xs * seg, bs)
    hins = state_pass(local, last)
    gram = torch.einsum("bcis,bcjs->bcij", cs, bs)
    y = (torch.einsum("bhcij,bhcjp->bhcip", gram[:, None] * decay, xs)
         + ecum * torch.einsum("bcis,bhcps->bhcip", cs, hins))
    return y.reshape(bh, n, p), hins.reshape(bh, n // chunk, p, -1)
