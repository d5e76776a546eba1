"""Plain PyTorch version of the flow_fused kernel at its flat shapes.

The math is ``attention/fused.py::fused_causal_forward``; the flat
(BH, G, N, D) layout is its (B, Hq, N, D) layout with B = BH and one kv
head per row.
"""
from __future__ import annotations

import torch

from repro_torch.attention.fused import fused_causal_forward
from repro_torch.core.flow_attention import FlowConfig


def flow_fused_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lens: torch.Tensor, *, chunk: int = 128, eps: float = 1e-6,
                   phi: str = "sigmoid", use_alloc: bool = True):
    """q: (BH, G, N, D); k: (BH, N, D); v: (BH, N, Dv); lens: (BH,).

    Returns (out (BH, G, N, Dv), (q_sum, k_sum, ko_sum, qi_sum) each
    (BH, D) fp32, z (BH,) fp32, s (BH, D, Dv) fp32): the boundary
    FlowState of each row, frozen at its own length.
    """
    cfg = FlowConfig(eps=eps, phi=phi, causal=True, strict_causal=True,
                     use_allocation=use_alloc, chunk_size=chunk)
    out, st = fused_causal_forward(q, k[:, None], v[:, None], cfg,
                                   return_state=True, lengths=lens)
    return out, (st.q_sum[:, 0], st.k_sum[:, 0], st.ko_sum[:, 0],
                 st.qi_sum[:, 0], st.z[:, 0], st.s[:, 0])
