"""Autograd for the port's kernels: ``FlowFusedDot``, ``FlowNCQside``,
``FlowNCFused`` and ``FlowChunkDot``.

The counterpart of ``repro/attention/vjp.py::flow_fused_dot``.  The
forward is K1 (``kernels/flow_fused/ops.py::flow_fused_call``) on a dense,
chunk-padded flat batch whose positions from ``n_valid`` on are padding;
the backward is K2 (``kernels/flow_fused/bwd.py::flow_fused_bwd_call``),
which recomputes the flows and the chunk states from q, k and v itself.
So the saved tensors are q, k, v and the O(d^2) totals (checked, not read
by K2), nothing (B, H, N)-sized.  The state outputs are differentiable, as
in the reference: their cotangents seed K2's reverse passes (zeros where
unused).

The non-causal pair mirrors ``repro/attention/vjp.py:144-236``:
``FlowNCQside`` is K7a forward and K7b backward; ``FlowNCFused`` runs K6
forward, and its backward the gradient of ``_nc_decomposed`` without
recomputing its output: the cheap O(M D) key-side reductions
(``nc_key_side``) in plain fp32 PyTorch under autograd, K7b on them for the
O(N D Dv) sink side, and the key-side cotangents K7b returns pulled back
onto (q, k, v) by autograd.  The reference recomputes the sink side's
output there and discards it; K7a is not launched in this backward.

``FlowChunkDot`` mirrors ``repro/attention/vjp.py:67-92``: K5a forward
(``out[g, i] = q[g, i] . sum_{j<=i} k_j^T v_j``); its backward runs K5a
again with k and v swapped for ``dq = flow_chunk_call(g, v, k)`` (the
carried state then accumulates v^T k = S^T) and K5b for dk and dv.  It
saves q, k and v only.  On CPU tensors every call runs its plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flow_chunk.ops import (flow_chunk_call,
                                                flow_chunk_dkv_call)
from repro_torch.kernels.flow_fused.bwd import flow_fused_bwd_call
from repro_torch.kernels.flow_fused.ops import flow_fused_call
from repro_torch.kernels.flow_nc.ops import (flow_nc_fused_call,
                                             flow_nc_qside_bwd_call,
                                             flow_nc_qside_call)


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


class FlowNCQside(torch.autograd.Function):
    """``FlowNCQside.apply(q, k_sum, ko_sum, kv, n_sinks, m_sources, eps)``
    -> (BH, N, Dv): the non-causal sink side, K7a forward and K7b backward.

    q: (BH, N, D); k_sum/ko_sum: (BH, D) and kv: (BH, D, Dv) fp32.
    """

    @staticmethod
    def forward(ctx, q, k_sum, ko_sum, kv, n_sinks: int, m_sources: int,
                eps: float):
        ctx.save_for_backward(q, k_sum, ko_sum, kv)
        ctx.args = dict(n_sinks=n_sinks, m_sources=m_sources, eps=eps)
        return flow_nc_qside_call(q, k_sum, ko_sum, kv, **ctx.args)

    @staticmethod
    def backward(ctx, g):
        q, k_sum, ko_sum, kv = ctx.saved_tensors
        dq, dk_sum, dko_sum, dkv = flow_nc_qside_bwd_call(
            q, k_sum, ko_sum, kv, g.to(q.dtype).contiguous(), **ctx.args)
        return dq, dk_sum, dko_sum, dkv, None, None, None


class _KvSum(torch.autograd.Function):
    """``kv = pk^T v_hat`` per (batch * head): the sum over the M sources in
    fp64, rounded to fp32 once; the pull-back, whose sums run over D, in
    fp32.  ``FlowNCFused``'s backward adds two large pull-backs of q, K7b's
    (which reads kv) and ``nc_key_side``'s, that nearly cancel: with kv
    summed in fp32 by the card's GEMM they moved a vision step's stage-1 wq
    gradient by 1.5e-4 of its size against an fp64 run (1.1e-5 with kv in
    fp64; the plain path 1.7e-5; ``tools/nc_grad_precision.py`` on an H100:
    16 images of 224 x 224, D = 6 over 3,136 tokens)."""

    @staticmethod
    def forward(ctx, pk, v_hat):
        ctx.save_for_backward(pk, v_hat)
        return torch.einsum("bmd,bme->bde", pk.double(),
                            v_hat.double()).float()

    @staticmethod
    def backward(ctx, dkv):
        pk, v_hat = ctx.saved_tensors
        return (torch.einsum("bde,bme->bmd", dkv, v_hat),
                torch.einsum("bmd,bde->bme", pk, dkv))


def nc_key_side(q, k, v, eps: float, use_comp: bool):
    """K6's key side in plain fp32 PyTorch: (k_sum, ko_sum (BH, D), kv
    (BH, D, Dv)), the reductions the sink side (K7a) reads; kv's sum over
    the sources in fp64 (``_KvSum``)."""
    m = k.shape[1]
    pq = torch.sigmoid(q.float())
    pk = torch.sigmoid(k.float())
    vf = v.float()
    k_sum = pk.sum(dim=1)  # (BH, D)
    q_sum = pq.sum(dim=1)
    src_out = 1.0 / torch.einsum("bmd,bd->bm", pk + eps, q_sum + eps)
    ko_sum = (pk * src_out[..., None]).sum(dim=1)
    sink_in = 1.0 / torch.einsum("bnd,bd->bn", pq + eps, k_sum + eps)
    qi_sum = (pq * sink_in[..., None]).sum(dim=1)
    if use_comp:
        cons_src = torch.einsum("bmd,bd->bm", pk + eps,
                                qi_sum + eps).clamp(-1.0, 1.0)
        v_hat = vf * (torch.softmax(cons_src, dim=-1) * float(m))[..., None]
    else:
        v_hat = vf
    kv = _KvSum.apply(pk, v_hat)
    return k_sum, ko_sum, kv.contiguous()


def _nc_decomposed(q, k, v, eps: float, use_comp: bool):
    """K6's math decomposed: the key side (``nc_key_side``, natively
    differentiable) feeding ``FlowNCQside``.  ``FlowNCFused.backward``
    computes this function's gradient (the tests hold it to autograd
    through this); the forward runs K6."""
    return FlowNCQside.apply(q, *nc_key_side(q, k, v, eps, use_comp),
                             q.shape[1], k.shape[1], eps)


class FlowNCFused(torch.autograd.Function):
    """``FlowNCFused.apply(q, k, v, eps, use_comp)`` -> (BH, NQ, Dv): the
    whole non-causal pair, K6 forward; the backward pulls ``g`` back
    through K7b and autograd of ``nc_key_side`` (the gradient of
    ``_nc_decomposed``, without K7a).

    q: (BH, NQ, D) raw; k: (BH, M, D); v: (BH, M, Dv).  Saves q, k, v
    only.
    """

    @staticmethod
    def forward(ctx, q, k, v, eps: float, use_comp: bool):
        ctx.save_for_backward(q, k, v)
        ctx.args = (eps, use_comp)
        return flow_nc_fused_call(q, k, v, eps=eps, use_comp=use_comp)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        eps, use_comp = ctx.args
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_(True) for x in (q, k, v)]
            key = nc_key_side(*inputs, eps, use_comp)
        dq, *d_key = flow_nc_qside_bwd_call(
            q, *(x.detach() for x in key), g.to(q.dtype).contiguous(),
            n_sinks=q.shape[1], m_sources=k.shape[1], eps=eps)
        dq_key, dk, dv = torch.autograd.grad(key, inputs, d_key)
        # q's two paths summed in q's dtype, as autograd sums them
        return (dq + dq_key.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None)


class FlowChunkDot(torch.autograd.Function):
    """``FlowChunkDot.apply(q, k, v)`` -> (BH, G, N, Dv): the causal dot,
    K5a forward; backward K5a on (g, v, k) for dq and K5b for dk, dv.

    q: (BH, G, N, D); k: (BH, N, D); v: (BH, N, Dv).
    """

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flow_chunk_call(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        dq = flow_chunk_call(g, v, k)
        dk, dv = flow_chunk_dkv_call(q, k, v, g)
        return dq, dk, dv
