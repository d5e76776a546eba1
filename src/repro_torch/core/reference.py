"""Quadratic O(N*M) oracle for non-causal Flow-Attention -- tests only.

The counterpart of ``repro/core/reference.py::flow_attention_nc_ref``.  It
materializes the full (N, M) attention matrix and must agree with the
linear implementations up to matmul reassociation.
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
