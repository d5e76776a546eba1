"""Plain PyTorch versions of the flow_fused kernels at their flat shapes.

``flow_fused_ref`` is K1's: the math is ``attention/fused.py::
fused_causal_forward``, whose (B, Hq, N, D) layout is the flat
(BH, G, N, D) one with B = BH and one kv head per row.  K2 has two:
``flow_fused_bwd_ref`` differentiates ``flow_fused_ref`` with autograd
(the independent oracle), and ``flow_fused_bwd_scan`` is the reverse tile
scan with the hand-written tile VJP that ``csrc/flow_fused_bwd.cu`` runs,
step for step, so the derivation can be checked where no kernel runs.
"""
from __future__ import annotations

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


def flow_fused_bwd_scan(q, k, v, lens, totals, g_out, g_sums, *,
                        tile: int = 32, eps: float = 1e-6,
                        phi: str = "sigmoid", use_alloc: bool = True):
    """K2's algorithm in PyTorch: gradients of the flow_fused forward.

    q: (BH, G, N, D); k: (BH, N, D); v: (BH, N, Dv); lens (BH,);
    ``totals`` the six state outputs K1 returned (the carry after each
    row's last position), ``g_out`` (BH, G, N, Dv) and ``g_sums`` their
    cotangents.  A forward pass over ``tile``-position tiles carries the
    five small sums (q/k/ko/qi sums and z) and keeps each tile's carry-in;
    then a reverse pass walks the tiles back to front.  Each tile
    recomputes its forward quantities from its carry-in, rebuilds S's
    carry-in by subtraction (S after the tile minus the tile's increment,
    starting from the total), and pulls the output cotangent and the
    carried state cotangent back through them by hand.  The carried
    cotangents it hands the tile before are the incoming ones plus this
    tile's contributions to its carry-in.  Returns (dq, dk, dv) in the
    primal dtypes; positions past ``lens`` get exactly zero.
    """
    f32 = torch.float32
    grp, n = q.shape[1:3]
    dev = q.device
    n_pad = padded_len(n, tile)
    pos_all = torch.arange(n_pad, dtype=f32, device=dev) + 1.0
    valid = (torch.arange(n_pad, device=dev)[None, :]
             < lens.to(dev)[:, None]).to(f32)  # (BH, n_pad)
    pq_all = phi_map(pad_seq(q.to(f32), n_pad, 2), phi) * valid[:, None, :, None]
    pk_all = phi_map(pad_seq(k.to(f32), n_pad, 1), phi) * valid[..., None]
    v_all = pad_seq(v.to(f32), n_pad, 1)
    go_all = pad_seq(g_out.to(f32), n_pad, 2)
    s_in = totals[5].to(f32)
    dq_c, dk_c, dko_c, dqi_c, dz_c, ds_c = (x.to(f32) for x in g_sums)
    tri = torch.tril(torch.ones((tile, tile), dtype=f32, device=dev))
    dq_all, dk_all, dv_all = (torch.zeros_like(x) for x in (pq_all, pk_all,
                                                           v_all))
    tiles = [slice(t0, t0 + tile) for t0 in range(0, n_pad, tile)]
    # forward pass: each tile's small carry-in
    run = tuple(torch.zeros_like(x, dtype=f32) for x in totals[:5])
    carry_in = []
    for sl in tiles:
        carry_in.append(run)
        _, run = _tile_flows(pq_all[:, :, sl], pk_all[:, sl], valid[:, sl],
                             pos_all[sl], grp, run, eps, use_alloc)
    for sl, run in zip(reversed(tiles), reversed(carry_in)):
        pq, pk, vt, go = pq_all[:, :, sl], pk_all[:, sl], v_all[:, sl], go_all[:, :, sl]
        m, p = valid[:, sl], pos_all[sl]
        pg = p * grp
        # (1)-(3) the tile's flows, recomputed from its carry-in
        (k_cs, q_cs, sink_in, src_out, ko_cs, qi_cs, alloc, raw, e,
         z), _ = _tile_flows(pq, pk, m, p, grp, run, eps, use_alloc)
        qin = pq * sink_in[..., None]
        # (4) competition normalizer; S's carry-in by subtraction
        r = p / z
        vw = vt * e[..., None]
        s_in = s_in - torch.einsum("btd,bte->bde", pk, vw)
        # (5) the tile's output before ratio and allocation: Y = intra + inter
        scores = torch.einsum("bgid,bjd->bgij", qin, pk) * tri
        y = (torch.einsum("bgij,bje->bgie", scores, vw)
             + torch.einsum("bgid,bde->bgie", qin, s_in))

        # pull back out = Y * r * alloc
        o_dot = (go * y).sum(-1)  # (BH, G, T)
        d_r = (alloc * o_dot).sum(1)
        d_alloc = r[:, None] * o_dot
        dy = go * (r[:, None, :, None] * alloc[..., None])
        # r = pos / z, z = z_in + cumsum(e): suffix sums plus the carry
        de = dz_c[:, None] + _suffix_sum(-d_r * r / z, 1)
        dz_c = de[:, 0]
        # aggregation: Y = tril(qin pk^T) vw + qin S_in; S_out = S_in + pk^T vw
        dsc = torch.einsum("bgie,bje->bgij", dy, vw) * tri
        d_vw = (torch.einsum("btd,bde->bte", pk, ds_c)
                + torch.einsum("bgij,bgie->bje", scores, dy))
        d_qin = (torch.einsum("bgie,bde->bgid", dy, s_in)
                 + torch.einsum("bgij,bjd->bgid", dsc, pk))
        d_pk = (torch.einsum("bde,bte->btd", ds_c, vw)
                + torch.einsum("bgij,bgid->bjd", dsc, qin))
        ds_c = ds_c + torch.einsum("bgid,bgie->bde", qin, dy)
        # competition: vw = v e, e = exp(clip(raw)) masked
        de = de + (d_vw * vt).sum(-1)
        dv_all[:, sl] = d_vw * e[..., None]
        d_raw = de * e * ((raw >= -1.0) & (raw <= 1.0)).to(f32) / p
        d_cs = (d_alloc * alloc * (1.0 - alloc) / pg if use_alloc
                else torch.zeros_like(d_alloc))
        # conservation: raw . (qi_cs + eps), cons_sink . (ko_cs + eps)
        d_pk = d_pk + d_raw[..., None] * (qi_cs + eps)
        u_qi = dqi_c[:, None] + _suffix_sum(d_raw[..., None] * (pk + eps), 1)
        dqi_c = u_qi[:, 0]
        d_qin = d_qin + u_qi[:, None]
        u_ko = dko_c[:, None] + _suffix_sum(
            (d_cs[..., None] * (pq + eps)).sum(1), 1)
        dko_c = u_ko[:, 0]
        d_pq = d_cs[..., None] * (ko_cs[:, None] + eps)
        d_pk = d_pk + u_ko * src_out[..., None]
        d_src_out = (u_ko * pk).sum(-1)
        # flows: qin = pq sink_in, sink_in = pos / den, src_out = pos G / den
        d_sink_in = (d_qin * pq).sum(-1)
        d_pq = d_pq + d_qin * sink_in[..., None]
        d_sink_den = -d_sink_in * sink_in * sink_in / p
        d_src_den = -d_src_out * src_out * src_out / pg
        d_pq = d_pq + d_sink_den[..., None] * (k_cs[:, None] + eps)
        d_pk = d_pk + d_src_den[..., None] * (q_cs + eps)
        u_k = dk_c[:, None] + _suffix_sum(
            (d_sink_den[..., None] * (pq + eps)).sum(1), 1)
        dk_c = u_k[:, 0]
        d_pk = d_pk + u_k
        u_q = dq_c[:, None] + _suffix_sum(d_src_den[..., None] * (pk + eps), 1)
        dq_c = u_q[:, 0]
        d_pq = d_pq + u_q[:, None]
        # phi, masked past each row's length
        dq_all[:, :, sl] = d_pq * _phi_grad(pq, phi) * m[:, None, :, None]
        dk_all[:, sl] = d_pk * _phi_grad(pk, phi) * m[..., None]
    return (dq_all[:, :, :n].to(q.dtype), dk_all[:, :n].to(k.dtype),
            dv_all[:, :n].to(v.dtype))
