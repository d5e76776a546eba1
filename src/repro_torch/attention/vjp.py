"""Autograd for the flow_fused kernels: ``FlowFusedDot``.

The counterpart of ``repro/attention/vjp.py::flow_fused_dot``.  The
forward is K1 (``kernels/flow_fused/ops.py::flow_fused_call``) on a dense,
chunk-padded flat batch whose positions from ``n_valid`` on are padding;
the backward is K2 (``kernels/flow_fused/bwd.py::flow_fused_bwd_call``), a
reverse scan that rebuilds each tile's carry-in from the six state totals.
So the saved tensors are q, k, v and the O(d^2) totals, nothing
(B, H, N)-sized.  The state outputs are differentiable, as in the
reference: their cotangents seed the scan (zeros where unused).  On CPU
tensors both calls run their plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flow_fused.bwd import flow_fused_bwd_call
from repro_torch.kernels.flow_fused.ops import flow_fused_call


class FlowFusedDot(torch.autograd.Function):
    """``FlowFusedDot.apply(q, k, v, n_valid, chunk, eps, phi, use_alloc)``
    -> (out, q_sum, k_sum, ko_sum, qi_sum, z, s).

    q: (BH, G, N, D); k: (BH, N, D); v: (BH, N, Dv); N % chunk == 0.
    """

    @staticmethod
    def forward(ctx, q, k, v, n_valid: int, chunk: int, eps: float,
                phi: str, use_alloc: bool):
        lens = torch.full((q.shape[0],), n_valid, dtype=torch.int32,
                          device=q.device)
        out, sums = flow_fused_call(q, k, v, lens, chunk=chunk, eps=eps,
                                    phi=phi, use_alloc=use_alloc)
        ctx.save_for_backward(q, k, v, lens, *sums)
        ctx.args = dict(chunk=chunk, eps=eps, phi=phi, use_alloc=use_alloc)
        return (out, *sums)

    @staticmethod
    def backward(ctx, g_out, *g_sums):
        q, k, v, lens, *totals = ctx.saved_tensors
        g_sums = [g.float().contiguous() for g in g_sums]
        dq, dk, dv = flow_fused_bwd_call(q, k, v, lens, totals,
                                         g_out.to(q.dtype).contiguous(),
                                         g_sums, **ctx.args)
        return dq, dk, dv, None, None, None, None, None
