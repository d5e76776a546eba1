"""Quadratic O(N*M) oracles for Flow-Attention -- tests only.

The counterparts of ``repro/core/reference.py::flow_attention_nc_ref`` and
``flow_attention_causal_ref``.  They materialize the full (N, M) attention
matrix and must agree with the linear implementations up to matmul
reassociation.
"""
from __future__ import annotations

import torch

from repro_torch.core.flow_attention import FlowConfig, _group, _ungroup, phi_map


def flow_attention_nc_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cfg: FlowConfig) -> torch.Tensor:
    """Quadratic non-causal oracle (expand-GQA by pre-repeating k/v,
    shared-GQA by grouped sums, mirroring the fast path)."""
    out_dtype = q.dtype
    eps = cfg.eps
    b, hq, n, d = q.shape
    hkv, m = k.shape[1], k.shape[2]
    if cfg.gqa_mode == "expand" and hq != hkv:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        hkv = hq

    phi_q = phi_map(q.float(), cfg.phi)
    phi_k = phi_map(k.float(), cfg.phi)
    vf = v.float()
    qg = _group(phi_q, hkv)

    k_sum = phi_k.sum(dim=2)
    q_sum = qg.sum(dim=(2, 3))
    sink_in = 1.0 / torch.einsum("bhgnd,bhd->bhgn", qg + eps, k_sum + eps)
    src_out = 1.0 / torch.einsum("bhmd,bhd->bhm", phi_k + eps, q_sum + eps)
    ko_sum = (phi_k * src_out[..., None]).sum(dim=2)
    cons_sink = torch.einsum("bhgnd,bhd->bhgn", qg + eps, ko_sum + eps)
    qi_sum = (qg * sink_in[..., None]).sum(dim=(2, 3))
    cons_src = torch.einsum("bhmd,bhd->bhm", phi_k + eps,
                            qi_sum + eps).clamp(-1.0, 1.0)

    n_sinks = qg.shape[2] * n
    if cfg.use_competition:
        v_hat = vf * (torch.softmax(cons_src, dim=-1) * float(m))[..., None]
    else:
        v_hat = vf
    if cfg.use_allocation:
        alloc = torch.sigmoid(cons_sink * (float(n_sinks) / float(m)))
    else:
        alloc = torch.ones_like(cons_sink)

    # quadratic: materialize the (n x m) attention matrix explicitly
    attn = torch.einsum("bhgnd,bhmd->bhgnm", qg * sink_in[..., None], phi_k)
    out = torch.einsum("bhgnm,bhme->bhgne", attn, v_hat) * alloc[..., None]
    return _ungroup(out).to(out_dtype)


def flow_attention_causal_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, cfg: FlowConfig) -> torch.Tensor:
    """Quadratic causal oracle for the three modes: paper-faithful
    (``strict_causal=False``), strict and no-competition."""
    out_dtype = q.dtype
    eps = cfg.eps
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    if cfg.gqa_mode == "expand" and hq != hkv:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        hkv = hq

    phi_q = phi_map(q.float(), cfg.phi)
    phi_k = phi_map(k.float(), cfg.phi)
    vf = v.float()
    qg = _group(phi_q, hkv)
    g = qg.shape[2]

    pos = torch.arange(1, n + 1, dtype=torch.float32, device=q.device)
    normal_q = pos * g
    normal_k = pos

    k_csum = torch.cumsum(phi_k, dim=2)
    q_csum = torch.cumsum(qg.sum(dim=2), dim=2)
    sink_in = normal_k / torch.einsum("bhgnd,bhnd->bhgn", qg + eps,
                                      k_csum + eps)
    src_out = normal_q / torch.einsum("bhnd,bhnd->bhn", phi_k + eps,
                                      q_csum + eps)
    ko_csum = torch.cumsum(phi_k * src_out[..., None], dim=2)
    cons_sink = torch.einsum("bhgnd,bhnd->bhgn", qg + eps,
                             ko_csum + eps) / normal_q
    qi_csum = torch.cumsum((qg * sink_in[..., None]).sum(dim=2), dim=2)
    cons_src = (torch.einsum("bhnd,bhnd->bhn", phi_k + eps, qi_csum + eps)
                / normal_k).clamp(-1.0, 1.0)

    alloc = (torch.sigmoid(cons_sink) if cfg.use_allocation
             else torch.ones_like(cons_sink))
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    attn = torch.einsum("bhgnd,bhmd->bhgnm", qg * sink_in[..., None], phi_k)
    attn = torch.where(mask, attn, 0.0)

    if not cfg.use_competition:
        out = torch.einsum("bhgnm,bhme->bhgne", attn, vf) * alloc[..., None]
    elif cfg.strict_causal:
        e = torch.exp(cons_src)  # (B,Hkv,N)
        z = torch.cumsum(e, dim=-1)
        agg = torch.einsum("bhgnm,bhme->bhgne", attn, vf * e[..., None])
        out = agg * (normal_k / z)[:, :, None, :, None] * alloc[..., None]
    else:
        comp = torch.softmax(cons_src, dim=-1) * float(n)
        out = (torch.einsum("bhgnm,bhme->bhgne", attn, vf * comp[..., None])
               * alloc[..., None])
    return _ungroup(out).to(out_dtype)
