"""Plain PyTorch versions of the flow_fused kernels at their flat shapes.

``flow_fused_ref`` is K1's: the math is ``attention/fused.py::
fused_causal_forward``, whose (B, Hq, N, D) layout is the flat
(BH, G, N, D) one with B = BH and one kv head per row.
``flow_fused_bwd_ref`` is K2's: it differentiates ``flow_fused_ref`` with
autograd (the independent oracle).  ``flow_fused_parallel`` and
``flow_fused_bwd_parallel`` are the kernels' own decomposition (flows by
levels over super-chunks, chunk states, a pass over the chunks, per-chunk
products, and for K2 the reverse pass and the flows' pull-back), stage by
stage as ``csrc/flow_fused.cu`` and ``csrc/flow_fused_bwd.cu`` run them,
so the algebra can be checked where no kernel runs.  Nothing on a path
calls them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.attention.fused import fused_causal_forward, pad_seq, padded_len
from repro_torch.core.flow_attention import FlowConfig, phi_map


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


def flow_fused_bwd_ref(q, k, v, lens, g_out, g_sums, *, chunk: int = 128,
                       eps: float = 1e-6, phi: str = "sigmoid",
                       use_alloc: bool = True):
    """Gradients of ``flow_fused_ref`` w.r.t. (q, k, v) by autograd, for
    the cotangent ``g_out`` on ``out`` and ``g_sums`` on the six state
    outputs.  Returns (dq, dk, dv) in the primal dtypes."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out, sums = flow_fused_ref(*leaves, lens, chunk=chunk, eps=eps,
                                   phi=phi, use_alloc=use_alloc)
        grads = torch.autograd.grad((out, *sums), leaves,
                                    (g_out.to(out.dtype), *g_sums),
                                    allow_unused=True)
    return tuple(torch.zeros_like(x) if gx is None else gx
                 for x, gx in zip(leaves, grads))


def _suffix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive suffix sum: element i is the sum of elements i.. end."""
    return x.flip(dim).cumsum(dim).flip(dim)


def _phi_grad(p: torch.Tensor, kind: str) -> torch.Tensor:
    """phi'(x) written in terms of p = phi(x)."""
    if kind == "sigmoid":
        return p * (1.0 - p)
    if kind == "elu1":  # elu(x) + 1 is x + 1 above 0 and exp(x) below
        return torch.where(p > 1.0, torch.ones_like(p), p)
    if kind == "relu":
        return (p > 0.0).to(p.dtype)
    raise ValueError(f"unknown phi {kind!r}")


def _tile_flows(pq, pk, m, p, grp, run, eps, use_alloc):
    """A tile's flows from its small carry-in ``run`` = (q, k, ko, qi sums,
    z): the in-tile prefix sums, sink_in, src_out, the allocation, the
    unclipped cons_src and e.  Returns them and the carry at the tile's
    end."""
    q_run, k_run, ko_run, qi_run, z_run = run
    pg = p * grp
    k_cs = k_run[:, None] + pk.cumsum(1)  # (BH, T, D)
    q_cs = q_run[:, None] + pq.sum(1).cumsum(1)
    sink_in = p / ((pq + eps) * (k_cs[:, None] + eps)).sum(-1)  # (BH, G, T)
    src_out = pg / ((pk + eps) * (q_cs + eps)).sum(-1)  # (BH, T)
    ko_cs = ko_run[:, None] + (pk * src_out[..., None]).cumsum(1)
    qi_cs = qi_run[:, None] + (pq * sink_in[..., None]).sum(1).cumsum(1)
    cons_sink = ((pq + eps) * (ko_cs[:, None] + eps)).sum(-1) / pg
    raw = ((pk + eps) * (qi_cs + eps)).sum(-1) / p
    alloc = torch.sigmoid(cons_sink) if use_alloc else torch.ones_like(cons_sink)
    e = torch.exp(raw.clamp(-1.0, 1.0)) * m
    z = z_run[:, None] + e.cumsum(1)
    end = (q_cs[:, -1], k_cs[:, -1], ko_cs[:, -1], qi_cs[:, -1], z[:, -1])
    return (k_cs, q_cs, sink_in, src_out, ko_cs, qi_cs, alloc, raw, e, z), end




def _operands(q, k, v, lens, n_pad, phi):
    """phi(q) (BH, G, n_pad, D) and phi(k) (BH, n_pad, D), zero past each
    row's length; fp32 v (BH, n_pad, Dv); the validity mask (BH, n_pad)
    and the 1-based positions (n_pad,)."""
    f32 = torch.float32
    dev = q.device
    pos = torch.arange(n_pad, dtype=f32, device=dev) + 1.0
    valid = (torch.arange(n_pad, device=dev)[None, :]
             < lens.to(dev)[:, None]).to(f32)
    pq = phi_map(pad_seq(q.to(f32), n_pad, 2), phi) * valid[:, None, :, None]
    pk = phi_map(pad_seq(k.to(f32), n_pad, 1), phi) * valid[..., None]
    return pq, pk, pad_seq(v.to(f32), n_pad, 1), valid, pos


def _flows(pq, pk, valid, pos, tile, eps, use_alloc):
    """Stage 1 (``flow_fwd_flows``, ``flow_bwd_flows``): the three flow
    levels, carried over super-chunks of ``tile`` positions.  Returns sink_in and the output
    scale r * alloc (BH, G, N), both zero past each row's length, e
    (BH, N), the boundary (q, k, ko, qi sums, z) and each super-chunk's
    carry-in of those five."""
    grp, n = pq.shape[1:3]
    run = (torch.zeros_like(pk[:, 0]),) * 4 + (torch.zeros_like(pk[:, 0, 0]),)
    sink, scale, es, carries = [], [], [], []
    for t0 in range(0, n, tile):
        sl = slice(t0, t0 + tile)
        carries.append(run)
        fl, run = _tile_flows(pq[:, :, sl], pk[:, sl], valid[:, sl], pos[sl],
                              grp, run, eps, use_alloc)
        live = valid[:, None, sl] > 0
        sink.append(torch.where(live, fl[2], 0.0))
        scale.append(torch.where(live, (pos[sl] / fl[9])[:, None] * fl[6], 0.0))
        es.append(fl[8])
    return (torch.cat(sink, 2), torch.cat(scale, 2), torch.cat(es, 1), run,
            carries)


def _chunk_states(a, b, chunk):
    """Stage 2 (``flow_fwd_state``, ``flow_bwd_state``): per chunk of
    positions, the sum over the group and the chunk of a^T b; a (BH, G, N,
    D), b (BH, G, N, Dv) -> (BH, N / chunk, D, Dv)."""
    bh, g, n, d = a.shape
    nc = n // chunk
    return torch.einsum("bgcjd,bgcje->bcde", a.reshape(bh, g, nc, chunk, d),
                        b.reshape(bh, g, nc, chunk, -1))


def _state_pass(delta, seed=None, reverse=False):
    """Stage 3 (``flow_fwd_pass``, ``flow_bwd_pass``): slot c becomes the
    sum of the chunk states before it (after it, with ``reverse``, starting
    from ``seed``), summed in chunk order.  Returns the slots and the sum
    over all chunks."""
    h = torch.zeros_like(delta[:, 0]) if seed is None else seed
    slots = torch.empty_like(delta)
    order = range(delta.shape[1])
    for c in (reversed(order) if reverse else order):
        slots[:, c] = h
        h = h + delta[:, c]
    return slots, h


def _chunked(x, chunk):
    """(..., N, F) -> (..., N / chunk, chunk, F)."""
    return x.reshape(*x.shape[:-2], x.shape[-2] // chunk, chunk, x.shape[-1])


def flow_fused_parallel(q, k, v, lens, *, chunk: int = 64, tile: int = 64,
                        eps: float = 1e-6, phi: str = "sigmoid",
                        use_alloc: bool = True):
    """K1's algorithm in PyTorch, stage by stage as ``csrc/flow_fused.cu``
    runs it; the arguments and results of ``flow_fused_ref``.

    ``tile`` is the flows' super-chunk and ``chunk`` the chunk of the
    state and output stages, both the kernel's own: (1) the flows by
    levels over super-chunks, (2) each chunk's state phi(k)^T (v e), (3)
    the exclusive pass over the chunks, (4) per chunk out = (tril(q_in
    phi(k)^T) (v e) + q_in S_<c) r alloc, with q_in = phi(q) sink_in.
    """
    grp, n = q.shape[1:3]
    n_pad = padded_len(n, math.lcm(chunk, tile))
    pq, pk, vf, valid, pos = _operands(q, k, v, lens, n_pad, phi)
    sink, scale, e, run, _ = _flows(pq, pk, valid, pos, tile, eps, use_alloc)
    qin = _chunked(pq * sink[..., None], chunk)  # (BH, G, nc, C, D)
    vw = vf * e[..., None]
    s_in, s = _state_pass(_chunk_states(pk[:, None], vw[:, None], chunk))
    kc, vc = _chunked(pk, chunk), _chunked(vw, chunk)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=pk.dtype,
                                device=pk.device))
    sc = torch.einsum("bgcid,bcjd->bgcij", qin, kc) * tri
    y = (torch.einsum("bgcij,bcje->bgcie", sc, vc)
         + torch.einsum("bgcid,bcde->bgcie", qin, s_in))
    out = y.reshape(*pq.shape[:3], -1) * scale[..., None]
    return out[:, :, :n].to(q.dtype), (*run, s)


def flow_fused_bwd_parallel(q, k, v, lens, g_out, g_sums, *, chunk: int = 64,
                            tile: int = 32, eps: float = 1e-6,
                            phi: str = "sigmoid", use_alloc: bool = True):
    """K2's algorithm in PyTorch, stage by stage as
    ``csrc/flow_fused_bwd.cu`` runs it; the arguments and results of
    ``flow_fused_bwd_ref``.

    ``tile`` is the pull-back's super-chunk, and so the spacing of the
    carries the flows save (the kernel's flows may walk larger super-chunks:
    that only reorders fp32 sums).  (1) the flows again, keeping the
    carry-in of every ``tile`` positions; (2) each
    chunk's state phi(k)^T (v e) and cotangent state q_in^T dY (dY =
    g_out r alloc, summed over the group); (3) S_<c by the forward pass,
    dS_>c by a reverse pass seeded with the S cotangent; (4) per chunk,
    g_out . Y, d q_in, d phi(k), d(v e) and so dv; (5) back to front over
    the super-chunks, the flows recomputed from their carry-ins and the
    three levels pulled back by suffix sums seeded with the cotangents of
    the four sums and z.  Nothing is rebuilt by subtraction.  Returns
    (dq, dk, dv) in the primal dtypes, zero past ``lens``.
    """
    f32 = torch.float32
    grp, n = q.shape[1:3]
    n_pad = padded_len(n, math.lcm(chunk, tile))
    pq, pk, vf, valid, pos = _operands(q, k, v, lens, n_pad, phi)
    go = pad_seq(g_out.to(f32), n_pad, 2)
    # (1)
    sink, scale, e, _, carries = _flows(pq, pk, valid, pos, tile, eps,
                                        use_alloc)
    qin = pq * sink[..., None]
    vw = vf * e[..., None]
    dy = go * scale[..., None]
    # (2), (3)
    s_in, _ = _state_pass(_chunk_states(pk[:, None], vw[:, None], chunk))
    ds_out, _ = _state_pass(_chunk_states(qin, dy, chunk), g_sums[5].to(f32),
                            reverse=True)
    # (4)
    qc, kc, vc, dyc = (_chunked(x, chunk) for x in (qin, pk, vw, dy))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=q.device))
    sc = torch.einsum("bgcid,bcjd->bgcij", qc, kc) * tri
    y = (torch.einsum("bgcij,bcje->bgcie", sc, vc)
         + torch.einsum("bgcid,bcde->bgcie", qc, s_in))
    o_dot = (_chunked(go, chunk) * y).sum(-1).reshape(pq.shape[:3])
    dsc = torch.einsum("bgcie,bcje->bgcij", dyc, vc) * tri
    dqin_all = (torch.einsum("bgcij,bcjd->bgcid", dsc, kc)
                + torch.einsum("bgcie,bcde->bgcid", dyc, s_in)
                ).reshape(pq.shape)
    dpk_all = (torch.einsum("bgcij,bgcid->bcjd", dsc, qc)
               + torch.einsum("bcje,bcde->bcjd", vc, ds_out)).reshape(pk.shape)
    d_vw = (torch.einsum("bgcij,bgcie->bcje", sc, dyc)
            + torch.einsum("bcjd,bcde->bcje", kc, ds_out)).reshape(vf.shape)
    dv_all = d_vw * (e * valid)[..., None]
    dvw_v = (d_vw * vf).sum(-1)
    # (5)
    dq_c, dk_c, dko_c, dqi_c, dz_c = (x.to(f32) for x in g_sums[:5])
    dq_all, dk_all = torch.zeros_like(pq), torch.zeros_like(pk)
    for t0, run in reversed(list(zip(range(0, n_pad, tile), carries))):
        sl = slice(t0, t0 + tile)
        pq_t, pk_t, m, p = pq[:, :, sl], pk[:, sl], valid[:, sl], pos[sl]
        pg = p * grp
        (k_cs, q_cs, sink_in, src_out, ko_cs, qi_cs, alloc, raw, e_t,
         z), _ = _tile_flows(pq_t, pk_t, m, p, grp, run, eps, use_alloc)
        r = p / z
        # out = Y r alloc; r = pos / z, z = z_in + cumsum(e)
        od = o_dot[:, :, sl]
        d_r = (alloc * od).sum(1)
        d_alloc = r[:, None] * od
        de = dz_c[:, None] + _suffix_sum(-d_r * r / z, 1)
        dz_c = de[:, 0]
        # e = exp(clip(raw)) masked; v e
        de = de + dvw_v[:, sl]
        d_raw = de * e_t * ((raw >= -1.0) & (raw <= 1.0)).to(f32) / p
        d_cs = (d_alloc * alloc * (1.0 - alloc) / pg if use_alloc
                else torch.zeros_like(d_alloc))
        # conservation: raw . (qi_cs + eps), cons_sink . (ko_cs + eps)
        d_pk = dpk_all[:, sl] + d_raw[..., None] * (qi_cs + eps)
        u_qi = dqi_c[:, None] + _suffix_sum(d_raw[..., None] * (pk_t + eps), 1)
        dqi_c = u_qi[:, 0]
        d_qin = dqin_all[:, :, sl] + u_qi[:, None]
        u_ko = dko_c[:, None] + _suffix_sum(
            (d_cs[..., None] * (pq_t + eps)).sum(1), 1)
        dko_c = u_ko[:, 0]
        d_pq = d_cs[..., None] * (ko_cs[:, None] + eps)
        d_pk = d_pk + u_ko * src_out[..., None]
        d_src_out = (u_ko * pk_t).sum(-1)
        # flows: q_in = phi(q) sink_in, sink_in = pos / den, src_out = pos G / den
        d_sink_in = (d_qin * pq_t).sum(-1)
        d_pq = d_pq + d_qin * sink_in[..., None]
        d_sink_den = -d_sink_in * sink_in * sink_in / p
        d_src_den = -d_src_out * src_out * src_out / pg
        d_pq = d_pq + d_sink_den[..., None] * (k_cs[:, None] + eps)
        d_pk = d_pk + d_src_den[..., None] * (q_cs + eps)
        u_k = dk_c[:, None] + _suffix_sum(
            (d_sink_den[..., None] * (pq_t + eps)).sum(1), 1)
        dk_c = u_k[:, 0]
        d_pk = d_pk + u_k
        u_q = dq_c[:, None] + _suffix_sum(d_src_den[..., None] * (pk_t + eps), 1)
        dq_c = u_q[:, 0]
        d_pq = d_pq + u_q[:, None]
        # phi, zero past each row's length
        live = m > 0
        dq_all[:, :, sl] = torch.where(live[:, None, :, None],
                                       d_pq * _phi_grad(pq_t, phi), 0.0)
        dk_all[:, sl] = torch.where(live[..., None],
                                    d_pk * _phi_grad(pk_t, phi), 0.0)
    return (dq_all[:, :, :n].to(q.dtype), dk_all[:, :n].to(k.dtype),
            dv_all[:, :n].to(v.dtype))
