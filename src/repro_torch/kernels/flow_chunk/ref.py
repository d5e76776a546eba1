"""Plain PyTorch version of K5a, the chunked causal aggregation.

The counterpart of ``repro/kernels/flow_chunk/ref.py::flow_chunk_ref``: a
cumsum of rank-1 updates, O(N D Dv) memory.  The small-size oracle of the
kernel (``csrc/flow_chunk.cu``); the plain version timed on the card is
``attention/chunked.py::chunked_causal_dot_grouped``.
"""
from __future__ import annotations

import torch


def flow_chunk_ref(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """q: (BH, G, N, D); k: (BH, N, D); v: (BH, N, Dv) -> (BH, G, N, Dv).

    out[b, g, i] = q[b, g, i] . sum_{j<=i} k[b, j]^T v[b, j]
    """
    kv = torch.einsum("bnd,bne->bnde", k.float(), v.float())
    kv = torch.cumsum(kv, dim=1)
    out = torch.einsum("bgnd,bnde->bgne", q.float(), kv)
    return out.to(q.dtype)
