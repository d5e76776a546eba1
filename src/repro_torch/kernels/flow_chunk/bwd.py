"""Plain PyTorch version of K5b, the reverse-causal dk/dv of K5a.

The counterpart of ``repro/kernels/flow_chunk/bwd.py::flow_chunk_dkv_ref``.
For ``out[g, i] = q[g, i] . sum_{j<=i} k_j^T v_j`` and its cotangent g:

    dk[j] = sum_{g, i>=j} (g[g, i] . v_j) q[g, i]
    dv[j] = sum_{g, i>=j} (q[g, i] . k_j) g[g, i]

(dq has the forward's structure with k and v swapped, so it is K5a on
(g, v, k)).  Masked (N, N) einsums: the small-size oracle of
``csrc/flow_chunk_bwd.cu``.
"""
from __future__ import annotations

import torch


def flow_chunk_dkv_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       g: torch.Tensor):
    """q: (BH, G, N, D); k: (BH, N, D); v: (BH, N, Dv); g: (BH, G, N, Dv)
    -> dk (BH, N, D) in k's dtype, dv (BH, N, Dv) in v's dtype."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    n = q.shape[2]
    mask = torch.ones((n, n), dtype=torch.float32, device=q.device).tril()
    sgv = torch.einsum("bgie,bje->bgij", gf, vf) * mask  # (i, j): i >= j
    dk = torch.einsum("bgij,bgid->bjd", sgv, qf)
    sqk = torch.einsum("bgid,bjd->bgij", qf, kf) * mask
    dv = torch.einsum("bgij,bgie->bje", sqk, gf)
    return dk.to(k.dtype), dv.to(v.dtype)
