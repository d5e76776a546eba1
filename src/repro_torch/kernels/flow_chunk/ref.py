"""Plain PyTorch versions of K5a, the chunked causal aggregation.

``flow_chunk_ref`` is the counterpart of
``repro/kernels/flow_chunk/ref.py::flow_chunk_ref``: a cumsum of rank-1
updates, O(N D Dv) memory, the small-size oracle of the kernel
(``csrc/flow_chunk.cu``); the plain version timed on the card is
``attention/chunked.py::chunked_causal_dot_grouped``.
``flow_chunk_parallel`` is the kernel's own decomposition, stage by stage.
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


def flow_chunk_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        chunk: int) -> torch.Tensor:
    """K5a's algorithm in PyTorch, as ``csrc/flow_chunk.cu`` runs it; the
    arguments and result of ``flow_chunk_ref``.

    The positions are cut into chunks of ``chunk`` (the last one padded
    with zeros): (1) each chunk's state H_c = k_c^T v_c; (2) the exclusive
    prefix S_c = H_0 + ... + H_{c-1}, summed in chunk order; (3) per chunk
    and group, out_c = q_c S_c + tril(q_c k_c^T) v_c.
    """
    bh, g, n, d = q.shape
    dv = v.shape[-1]
    nc = -(-n // chunk)
    pad = nc * chunk - n
    f32 = torch.float32
    qc = torch.nn.functional.pad(q.to(f32), (0, 0, 0, pad)).reshape(
        bh, g, nc, chunk, d)
    kc = torch.nn.functional.pad(k.to(f32), (0, 0, 0, pad)).reshape(
        bh, nc, chunk, d)
    vc = torch.nn.functional.pad(v.to(f32), (0, 0, 0, pad)).reshape(
        bh, nc, chunk, dv)
    h = torch.einsum("bctd,bcte->bcde", kc, vc)  # (1)
    s = torch.zeros_like(h)  # (2): S_0 = 0
    for c in range(1, nc):
        s[:, c] = s[:, c - 1] + h[:, c - 1]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=q.device))
    panel = torch.einsum("bgcid,bcjd->bgcij", qc, kc) * tri  # (3)
    out = (torch.einsum("bgcid,bcde->bgcie", qc, s)
           + torch.einsum("bgcij,bcje->bgcie", panel, vc))
    return out.reshape(bh, g, nc * chunk, dv)[:, :, :n].to(q.dtype)
