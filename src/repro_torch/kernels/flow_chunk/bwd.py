"""Plain PyTorch version of K5b, the reverse-causal dk/dv of K5a.

The counterpart of ``repro/kernels/flow_chunk/bwd.py::flow_chunk_dkv_ref``.
For ``out[g, i] = q[g, i] . sum_{j<=i} k_j^T v_j`` and its cotangent g:

    dk[j] = sum_{g, i>=j} (g[g, i] . v_j) q[g, i]
    dv[j] = sum_{g, i>=j} (q[g, i] . k_j) g[g, i]

(dq has the forward's structure with k and v swapped, so it is K5a on
(g, v, k)).  ``flow_chunk_dkv_ref``: masked (N, N) einsums, the small-size
oracle of ``csrc/flow_chunk_bwd.cu``; ``flow_chunk_dkv_parallel``: the
kernel's own decomposition, stage by stage.
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


def flow_chunk_dkv_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            g: torch.Tensor, chunk: int):
    """K5b's algorithm in PyTorch, as ``csrc/flow_chunk_bwd.cu`` runs it;
    the arguments and results of ``flow_chunk_dkv_ref``.

    The positions are cut into chunks of ``chunk`` (the last one padded
    with zeros): (1) each chunk's state U_c = sum_g q_{c,g}^T g_{c,g};
    (2) the exclusive suffix U_{>c} = U_{c+1} + ... + U_{nc-1}, summed from
    the last chunk down; (3) per chunk, dk_c = v_c U_{>c}^T + sum_g
    tril(g_{c,g} v_c^T)^T q_{c,g} and dv_c = k_c U_{>c} + sum_g
    tril(q_{c,g} k_c^T)^T g_{c,g}.
    """
    bh, grp, n, d = q.shape
    dv = v.shape[-1]
    nc = -(-n // chunk)
    pad = nc * chunk - n
    f32 = torch.float32
    padded = lambda x, *s: torch.nn.functional.pad(  # noqa: E731
        x.to(f32), (0, 0, 0, pad)).reshape(*s)
    qc, gc = padded(q, bh, grp, nc, chunk, d), padded(g, bh, grp, nc, chunk, dv)
    kc, vc = padded(k, bh, nc, chunk, d), padded(v, bh, nc, chunk, dv)
    u = torch.einsum("bgctd,bgcte->bcde", qc, gc)  # (1)
    s = torch.zeros_like(u)  # (2): U_{>nc-1} = 0
    for c in range(nc - 2, -1, -1):
        s[:, c] = s[:, c + 1] + u[:, c + 1]
    # (3): the transposed panels, rows j (keys), columns i >= j (queries)
    keep = torch.triu(torch.ones((chunk, chunk), dtype=f32, device=q.device))
    p1 = torch.einsum("bcje,bgcie->bgcji", vc, gc) * keep
    p2 = torch.einsum("bcjd,bgcid->bgcji", kc, qc) * keep
    dk = (torch.einsum("bgcji,bgcid->bcjd", p1, qc)
          + torch.einsum("bcje,bcde->bcjd", vc, s))
    dvv = (torch.einsum("bgcji,bgcie->bcje", p2, gc)
           + torch.einsum("bcjd,bcde->bcje", kc, s))
    return (dk.reshape(bh, nc * chunk, d)[:, :n].to(k.dtype),
            dvv.reshape(bh, nc * chunk, dv)[:, :n].to(v.dtype))
