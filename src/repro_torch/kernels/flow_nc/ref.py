"""Plain PyTorch versions of the flow_nc kernels (K6, K7a, K7b).

* ``flow_nc_fused_ref`` (K6): the whole non-causal pair, as the phased
  kernel computes it -- key-side sums, conservation sums, the
  ``e``-weighted ``kv`` with a DEFERRED softmax normalizer ``m / z``
  (exact: ``cons_src`` is clipped to [-1, 1], so ``exp`` needs no max
  subtraction), then the sink rows.  Sigmoid phi and allocation, as in
  ``repro/kernels/flow_nc/fused.py``.
* ``flow_nc_fused_parallel`` (K6 as the CUDA kernel splits it): each
  (batch * kv head) cut over ``cb`` blocks of a thread-block cluster, each
  owning ceil(NQ / cb) sink and ceil(M / cb) source rows (the last ones
  possibly none); every phase's totals are the blocks' partials summed in
  rank order, ``kv`` included.
* ``flow_nc_qside_ref`` (K7a): the sink side from the key-side reductions
  (``repro/kernels/flow_nc/ref.py``).
* ``flow_nc_qside_bwd_ref`` (K7b): K7a's cotangents, the chain of
  ``repro/kernels/flow_nc/bwd.py`` written out by hand (no autograd), so
  that a test against autograd checks the formula.
* ``flow_nc_qside_bwd_parallel`` (K7b as the CUDA kernel splits it): each
  (batch * head)'s rows cut into blocks of ``rows``, each block's partial
  dk_sum, dko_sum and dkv, the totals those partials added in block order.

Everything is computed in fp32; outputs take q's dtype, the key-side
cotangents fp32.
"""
from __future__ import annotations

import torch


def flow_nc_fused_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      eps: float = 1e-6, use_comp: bool = True) -> torch.Tensor:
    """q: (BH, NQ, D) raw; k: (BH, M, D); v: (BH, M, Dv) -> (BH, NQ, Dv).

    NQ counts sinks (G*N after GQA grouping); the allocation scale is NQ/M.
    """
    nq, m = q.shape[1], k.shape[1]
    pq = torch.sigmoid(q.float())
    pk = torch.sigmoid(k.float())
    vf = v.float()
    # phase A: plain sums
    k_sum = pk.sum(dim=1)  # (BH, D)
    q_sum = pq.sum(dim=1)
    # phase B: conservation sums
    src_out = 1.0 / torch.einsum("bmd,bd->bm", pk + eps, q_sum + eps)
    ko_sum = (pk * src_out[..., None]).sum(dim=1)
    sink_in = 1.0 / torch.einsum("bnd,bd->bn", pq + eps, k_sum + eps)
    qi_sum = (pq * sink_in[..., None]).sum(dim=1)
    # phase C: competition-weighted kv, deferred normalizer
    if use_comp:
        e = torch.exp(torch.einsum("bmd,bd->bm", pk + eps,
                                   qi_sum + eps).clamp(-1.0, 1.0))
    else:
        e = torch.ones(pk.shape[:2], dtype=torch.float32, device=pk.device)
    z = e.sum(dim=1)  # (BH,)
    kv = torch.einsum("bmd,bme->bde", pk, vf * e[..., None])
    # phase D: sink side over the finished kv
    incoming = torch.einsum("bnd,bd->bn", pq + eps, k_sum + eps)
    conserved = torch.einsum("bnd,bd->bn", pq + eps, ko_sum + eps)
    alloc = torch.sigmoid(conserved * (float(nq) / float(m)))
    agg = torch.einsum("bnd,bde->bne", pq / incoming[..., None], kv)
    scale = float(m) / z  # the softmax normalizer, applied once
    return (agg * alloc[..., None] * scale[:, None, None]).to(q.dtype)


def _rank_sum(parts):
    """The partials of blocks 0, 1, ... added in that order."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def flow_nc_fused_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, cb: int = 8, eps: float = 1e-6,
                           use_comp: bool = True) -> torch.Tensor:
    """``flow_nc_fused_ref`` computed as ``csrc/flow_nc_fused.cu`` splits
    it: block r of a ``cb``-block cluster owns sink rows [r rq, (r+1) rq)
    and source rows [r rk, (r+1) rk) (rq = ceil(NQ / cb), rk =
    ceil(M / cb), clipped, so trailing blocks may own none).  Each phase
    forms per-block partials (k_sum and q_sum; ko_sum and qi_sum; z and
    kv), and every block takes the totals as the partials of blocks 0 ..
    cb - 1 added in rank order; then each block writes its own sink rows.
    """
    nq, m = q.shape[1], k.shape[1]
    rq, rk = -(-nq // cb), -(-m // cb)
    pq = torch.sigmoid(q.float())
    pk = torch.sigmoid(k.float())
    vf = v.float()
    qs = [pq[:, r * rq:(r + 1) * rq] for r in range(cb)]
    ks = [pk[:, r * rk:(r + 1) * rk] for r in range(cb)]
    vs = [vf[:, r * rk:(r + 1) * rk] for r in range(cb)]
    # phase A
    k_sum = _rank_sum([x.sum(dim=1) for x in ks])
    q_sum = _rank_sum([x.sum(dim=1) for x in qs])
    # phase B
    ko_sum = _rank_sum([(x / torch.einsum("bmd,bd->bm", x + eps, q_sum + eps)
                         [..., None]).sum(dim=1) for x in ks])
    qi_sum = _rank_sum([(x / torch.einsum("bnd,bd->bn", x + eps, k_sum + eps)
                         [..., None]).sum(dim=1) for x in qs])
    # phase C: per-block z and kv partials
    es = [torch.exp(torch.einsum("bmd,bd->bm", x + eps, qi_sum + eps)
                    .clamp(-1.0, 1.0)) if use_comp
          else torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
          for x in ks]
    z = _rank_sum([e.sum(dim=1) for e in es])
    kv = _rank_sum([torch.einsum("bmd,bme->bde", x, y * e[..., None])
                    for x, y, e in zip(ks, vs, es)])
    # phase D: each block's sink rows
    outs = []
    for x in qs:
        incoming = torch.einsum("bnd,bd->bn", x + eps, k_sum + eps)
        conserved = torch.einsum("bnd,bd->bn", x + eps, ko_sum + eps)
        alloc = torch.sigmoid(conserved * (float(nq) / float(m)))
        agg = torch.einsum("bnd,bde->bne", x, kv)
        scale = alloc / incoming * (float(m) / z)[:, None]
        outs.append(agg * scale[..., None])
    return torch.cat(outs, dim=1).to(q.dtype)


def _qside_chain(q, k_sum, ko_sum, kv, n_sinks, m_sources, eps):
    """The per-row forward chain both K7a and K7b compute."""
    phi = torch.sigmoid(q.float())
    ks, kos = k_sum.float() + eps, ko_sum.float() + eps
    incoming = torch.einsum("bnd,bd->bn", phi + eps, ks)[..., None]
    conserved = torch.einsum("bnd,bd->bn", phi + eps, kos)[..., None]
    alloc = torch.sigmoid(conserved * (float(n_sinks) / float(m_sources)))
    q_in = phi / incoming
    agg = torch.einsum("bnd,bde->bne", q_in, kv.float())
    return phi, ks, kos, incoming, alloc, q_in, agg


def flow_nc_qside_ref(q: torch.Tensor, k_sum: torch.Tensor,
                      ko_sum: torch.Tensor, kv: torch.Tensor, *,
                      n_sinks: int, m_sources: int,
                      eps: float = 1e-6) -> torch.Tensor:
    """q: (BH, N, D); k_sum/ko_sum: (BH, D); kv: (BH, D, Dv) -> (BH, N, Dv)."""
    *_, alloc, _, agg = _qside_chain(q, k_sum, ko_sum, kv, n_sinks,
                                     m_sources, eps)
    return (agg * alloc).to(q.dtype)


def flow_nc_qside_bwd_ref(q: torch.Tensor, k_sum: torch.Tensor,
                          ko_sum: torch.Tensor, kv: torch.Tensor,
                          g: torch.Tensor, *, n_sinks: int, m_sources: int,
                          eps: float = 1e-6):
    """Cotangents of ``flow_nc_qside_ref`` w.r.t. (q, k_sum, ko_sum, kv)
    for the output cotangent ``g`` (BH, N, Dv).  Returns (dq in q's dtype,
    dk_sum, dko_sum, dkv in fp32)."""
    phi, ks, kos, incoming, alloc, q_in, agg = _qside_chain(
        q, k_sum, ko_sum, kv, n_sinks, m_sources, eps)
    sink_scale = float(n_sinks) / float(m_sources)
    g = g.float()
    dagg = g * alloc  # (BH, N, Dv)
    dalloc = (g * agg).sum(dim=-1, keepdim=True)  # (BH, N, 1)
    dq_in = torch.einsum("bne,bde->bnd", dagg, kv.float())
    dincoming = -(dq_in * q_in).sum(dim=-1, keepdim=True) / incoming
    dconserved = dalloc * alloc * (1.0 - alloc) * sink_scale
    dphi = (dq_in / incoming + dincoming * ks[:, None, :]
            + dconserved * kos[:, None, :])
    dq = dphi * phi * (1.0 - phi)
    dk_sum = (dincoming * (phi + eps)).sum(dim=1)
    dko_sum = (dconserved * (phi + eps)).sum(dim=1)
    dkv = torch.einsum("bnd,bne->bde", q_in, dagg)
    return dq.to(q.dtype), dk_sum, dko_sum, dkv


def flow_nc_qside_bwd_parallel(q: torch.Tensor, k_sum: torch.Tensor,
                               ko_sum: torch.Tensor, kv: torch.Tensor,
                               g: torch.Tensor, *, n_sinks: int,
                               m_sources: int, rows: int, eps: float = 1e-6):
    """``flow_nc_qside_bwd_ref`` summed as ``csrc/flow_nc_qside.cu`` splits
    it: block b owns rows [b rows, (b+1) rows) of each (batch * head) and
    forms the partials sum_i dI_i (phi_i + eps), sum_i dC_i (phi_i + eps)
    and phi_b^T u_b (u = g alloc / I) over its rows; each total is the
    blocks' partials added in block order.  dq is per row, as there."""
    phi, ks, kos, incoming, alloc, _, agg = _qside_chain(
        q, k_sum, ko_sum, kv, n_sinks, m_sources, eps)
    sink_scale = float(n_sinks) / float(m_sources)
    g = g.float()
    u = g * alloc / incoming  # (BH, N, Dv)
    dalloc = (g * agg).sum(dim=-1, keepdim=True)
    w = torch.einsum("bne,bde->bnd", u, kv.float())
    dincoming = -(w * phi).sum(dim=-1, keepdim=True) / incoming
    dconserved = dalloc * alloc * (1.0 - alloc) * sink_scale
    dq = (w + dincoming * ks[:, None, :] + dconserved * kos[:, None, :]) \
        * phi * (1.0 - phi)
    blocks = range(0, q.shape[1], rows)
    cut = lambda x: [x[:, b:b + rows] for b in blocks]  # noqa: E731
    phis, us, dis, dcs = cut(phi), cut(u), cut(dincoming), cut(dconserved)
    dk_sum = _rank_sum([(d * (p + eps)).sum(dim=1) for d, p in zip(dis, phis)])
    dko_sum = _rank_sum([(d * (p + eps)).sum(dim=1)
                         for d, p in zip(dcs, phis)])
    dkv = _rank_sum([torch.einsum("bnd,bne->bde", p, x)
                     for p, x in zip(phis, us)])
    return dq.to(q.dtype), dk_sum, dko_sum, dkv
