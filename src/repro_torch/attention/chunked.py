"""Chunked causal linear attention: the plain scan of the causal dot.

The counterpart of ``repro/attention/chunked.py``.  Split the sequence into
chunks of C positions; for chunk c

    intra_c = tril(Q_c K_c^T) V_c          # (C, C) x (C, Dv) products
    inter_c = Q_c S_c                      # (C, D) x (D, Dv)
    S_{c+1} = S_c + K_c^T V_c              # carried (D, Dv) fp32 state

A Python loop over chunks stands for ``lax.scan``.  This is the plain
``chunked`` backend's dot and the plain version K5a (``kernels/
flow_chunk``) is timed against on the card.
"""
from __future__ import annotations

import torch


def chunked_causal_dot(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       chunk_size: int) -> torch.Tensor:
    """out_i = q_i . sum_{j<=i} k_j^T v_j  with q, k: (..., N, D); v:
    (..., N, Dv).  N must be divisible by ``chunk_size``."""
    return chunked_causal_dot_grouped(q.unsqueeze(-3), k, v,
                                      chunk_size).squeeze(-3)


def chunked_causal_dot_grouped(qg: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               chunk_size: int) -> torch.Tensor:
    """Grouped-query variant sharing the carried state across the group.

    qg: (..., G, N, D); k: (..., N, D); v: (..., N, Dv) -> (..., G, N, Dv)
    in qg's dtype.  Products in fp32.
    """
    n, c = qg.shape[-2], chunk_size
    if c <= 0 or n % c:
        raise ValueError(f"sequence {n} not divisible by chunk {c}")
    mask = torch.ones((c, c), dtype=torch.float32, device=qg.device).tril()
    state = torch.zeros(k.shape[:-2] + (k.shape[-1], v.shape[-1]),
                        dtype=torch.float32, device=qg.device)
    outs = []
    for s in range(0, n, c):
        qb = qg[..., s:s + c, :].float()
        kb, vb = k[..., s:s + c, :].float(), v[..., s:s + c, :].float()
        scores = torch.einsum("...gid,...jd->...gij", qb, kb)
        intra = torch.einsum("...gij,...je->...gie", scores * mask, vb)
        inter = torch.einsum("...gid,...de->...gie", qb, state)
        state = state + torch.einsum("...jd,...je->...de", kb, vb)
        outs.append((intra + inter).to(qg.dtype))
    return torch.cat(outs, dim=-2)
