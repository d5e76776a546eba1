"""Unfused non-causal Flow-Attention and the GQA expansion.

The counterpart of ``repro/attention/pipeline.py`` for this port's slices:
``expand_kv`` (``gqa_mode="expand"``) and ``nc_forward``, the plain
PyTorch non-causal Flow-Attention of paper Eq. 4/7/8.  ``nc_forward`` is
the plain ``nc`` backend and the path the flow_nc CUDA kernels are held
against.
"""
from __future__ import annotations

import torch

from repro_torch.core.flow_attention import FlowConfig, _group, _ungroup, phi_map


def expand_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cfg: FlowConfig):
    """Apply ``gqa_mode="expand"`` by repeating kv heads to query heads."""
    hq, hkv = q.shape[1], k.shape[1]
    if cfg.gqa_mode == "expand" and hq != hkv:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


def nc_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cfg: FlowConfig) -> torch.Tensor:
    """Non-causal Flow-Attention (paper Eq. 4/7/8) in plain PyTorch.

    q: (B, Hq, N, D); k: (B, Hkv, M, D); v: (B, Hkv, M, Dv) with Hkv | Hq.
    Returns (B, Hq, N, Dv) in q's dtype.
    """
    out_dtype = q.dtype
    eps = cfg.eps
    n = q.shape[2]
    k, v = expand_kv(q, k, v, cfg)
    hkv, m = k.shape[1], k.shape[2]

    phi_q = phi_map(q.float(), cfg.phi)  # (B,Hq,N,D)
    phi_k = phi_map(k.float(), cfg.phi)  # (B,Hkv,M,D)
    vf = v.float()

    qg = _group(phi_q, hkv)  # (B,Hkv,G,N,D)

    # (1) incoming / outgoing flows (Eq. 4 + official eps placement)
    k_sum = phi_k.sum(dim=2)  # (B,Hkv,D)
    q_sum = qg.sum(dim=(2, 3))  # (B,Hkv,D): sums over group and positions
    sink_in = 1.0 / torch.einsum("bhgnd,bhd->bhgn", qg + eps, k_sum + eps)
    src_out = 1.0 / torch.einsum("bhmd,bhd->bhm", phi_k + eps, q_sum + eps)

    # (2) conservation refinement (Eq. 7)
    ko_sum = (phi_k * src_out[..., None]).sum(dim=2)  # (B,Hkv,D)
    cons_sink = torch.einsum("bhgnd,bhd->bhgn", qg + eps, ko_sum + eps)
    qi_sum = (qg * sink_in[..., None]).sum(dim=(2, 3))  # (B,Hkv,D)
    cons_src = torch.einsum("bhmd,bhd->bhm", phi_k + eps, qi_sum + eps)
    cons_src = cons_src.clamp(-1.0, 1.0)  # official stability clamp

    # (3) competition & allocation (Eq. 8, official n/m scalings)
    n_sinks = qg.shape[2] * n  # G*N sinks per kv head (shared mode)
    if cfg.use_competition:
        comp = torch.softmax(cons_src, dim=-1) * float(m)  # (B,Hkv,M)
        v_hat = vf * comp[..., None]
    else:
        v_hat = vf
    if cfg.use_allocation:
        alloc = torch.sigmoid(cons_sink * (float(n_sinks) / float(m)))
    else:
        alloc = torch.ones_like(cons_sink)

    # (4) linear aggregation: (phiQ * I^-1) @ (phiK^T @ V_hat)
    kv = torch.einsum("bhmd,bhme->bhde", phi_k, v_hat)  # (B,Hkv,D,Dv)
    agg = torch.einsum("bhgnd,bhde->bhgne", qg * sink_in[..., None], kv)
    out = agg * alloc[..., None]
    return _ungroup(out).to(out_dtype)
