"""Unfused Flow-Attention math shared by the plain and causal-dot backends.

The counterpart of ``repro/attention/pipeline.py`` for this port's slices:
``expand_kv`` (``gqa_mode="expand"``), ``nc_forward`` (the plain non-causal
Flow-Attention of paper Eq. 4/7/8; the ``nc`` backend and the path the
flow_nc CUDA kernels are held against) and ``causal_forward`` (paper Alg.
2 in all three causal modes).  ``causal_forward`` takes the causal
aggregation ``out_i = q'_i . sum_{j<=i} phiK_j^T V_hat_j`` as a ``dot_fn``
argument, so the cumsum, chunked-scan and K5a backends share the flow
math.  ``causal_verify`` scores a drafted window of speculative decoding
from a carried ``FlowState`` in one pass and returns every position's
boundary state (the trajectory rollback gathers).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.flow_attention import FlowConfig, _group, _ungroup, phi_map

DotFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


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


def causal_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: FlowConfig, dot_fn: DotFn, *,
                   return_state: bool = False,
                   lengths: torch.Tensor | None = None):
    """Causal Flow-Attention (paper Alg. 2) with an injected aggregation.

    q: (B, Hq, N, D); k: (B, Hkv, N, D); v: (B, Hkv, N, Dv); N == M.
    ``dot_fn(qg, k, v)`` computes the grouped causal dot (B,Hkv,G,N,D) x
    (B,Hkv,N,D) x (B,Hkv,N,Dv) -> (B,Hkv,G,N,Dv); it is handed fp32
    operands.  With ``return_state=True`` (requires strict causal
    competition) also returns the O(d^2) ``FlowState`` that decode
    continues from; ``lengths`` (B,) then gathers each right-padded row's
    state at its own boundary ``lengths[i] - 1``.  Outputs at padded
    positions are garbage by construction.
    """
    out_dtype = q.dtype
    eps = cfg.eps
    b, hq, n, d = q.shape
    if k.shape[2] != n:
        raise ValueError("causal flow attention requires N == M")
    if return_state and not (cfg.strict_causal and cfg.use_competition):
        raise ValueError("recurrent decode state requires strict_causal "
                         "competition")
    if lengths is not None and not return_state:
        raise ValueError("per-row lengths only affect the returned FlowState")
    k, v = expand_kv(q, k, v, cfg)
    hkv = k.shape[1]

    phi_q = phi_map(q.float(), cfg.phi)
    phi_k = phi_map(k.float(), cfg.phi)
    vf = v.float()

    qg = _group(phi_q, hkv)  # (B,Hkv,G,N,D)
    g = qg.shape[2]

    # position counts ("normal" in the official code): G sinks per position
    pos = torch.arange(1, n + 1, dtype=torch.float32, device=q.device)
    normal_q = pos * g
    normal_k = pos

    # (1) incoming / outgoing flows from inclusive cumsums
    k_csum = torch.cumsum(phi_k, dim=2)  # (B,Hkv,N,D)
    q_csum = torch.cumsum(qg.sum(dim=2), dim=2)  # summed over the group
    sink_in = 1.0 / torch.einsum("bhgnd,bhnd->bhgn", qg + eps, k_csum + eps)
    sink_in = sink_in * normal_k  # official: rescale by count of sources
    src_out = 1.0 / torch.einsum("bhnd,bhnd->bhn", phi_k + eps, q_csum + eps)
    src_out = src_out * normal_q

    # (2) conservation refinement
    ko_csum = torch.cumsum(phi_k * src_out[..., None], dim=2)
    cons_sink = torch.einsum("bhgnd,bhnd->bhgn", qg + eps,
                             ko_csum + eps) / normal_q
    qi_csum = torch.cumsum((qg * sink_in[..., None]).sum(dim=2), dim=2)
    cons_src = torch.einsum("bhnd,bhnd->bhn", phi_k + eps,
                            qi_csum + eps) / normal_k
    cons_src = cons_src.clamp(-1.0, 1.0)

    # (3) competition & allocation
    if cfg.use_allocation:
        alloc = torch.sigmoid(cons_sink)  # (B,Hkv,G,N)
    else:
        alloc = torch.ones_like(cons_sink)

    q_in = qg * sink_in[..., None]  # value-normalized queries
    if not cfg.use_competition:
        out = dot_fn(q_in, phi_k, vf) * alloc[..., None]
        return _ungroup(out).to(out_dtype)

    if not cfg.strict_causal:
        # paper-faithful: softmax over the full length, scaled by N
        comp = torch.softmax(cons_src, dim=-1) * float(n)  # (B,Hkv,N)
        out = dot_fn(q_in, phi_k, vf * comp[..., None]) * alloc[..., None]
        return _ungroup(out).to(out_dtype)

    # strict: cumulative softmax, weight_{i,j} = exp(cs_j) / Z_i * normal_k_i
    e = torch.exp(cons_src)  # bounded in [1/e, e] by the clamp
    z = torch.cumsum(e, dim=-1)  # (B,Hkv,N)
    v_w = vf * e[..., None]
    agg = dot_fn(q_in, phi_k, v_w)
    out = agg * (normal_k / z)[:, :, None, :, None] * alloc[..., None]
    out = _ungroup(out).to(out_dtype)
    if not return_state:
        return out
    from repro_torch.attention.recurrent import FlowState  # lazy: cycle

    if lengths is None:
        t = torch.full((b,), n, dtype=torch.int32, device=q.device)
        li = torch.full((b,), n - 1, dtype=torch.long, device=q.device)
        k_mask = phi_k
    else:
        t = lengths.to(device=q.device, dtype=torch.int32)
        li = (t.clamp(min=1) - 1).long()  # (B,) boundary index per row
        valid = (torch.arange(n, device=q.device) < t[:, None]).float()
        k_mask = phi_k * valid[:, None, :, None]
    rows = torch.arange(b, device=q.device)

    def gat(a):  # (B, Hkv, N, ...) -> (B, Hkv, ...) at each row's boundary
        return a[rows, :, li]

    state = FlowState(
        t=t, q_sum=gat(q_csum), k_sum=gat(k_csum), ko_sum=gat(ko_csum),
        qi_sum=gat(qi_csum), z=gat(z),
        s=torch.einsum("bhnd,bhne->bhde", k_mask, v_w))
    return out, state


def causal_verify(state, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: FlowConfig):
    """Score a drafted window of n tokens in one pass from ``state``.

    The speculative-decoding verifier: continues the strict-causal
    recurrence from a boundary ``FlowState`` over ``n = k_draft + 1``
    window positions, producing every position's output and every
    position's boundary state at once: the inclusive cumsums of the window
    are the per-position states, so accept-prefix rollback is a gather
    (``recurrent.select_state``), not a recompute.

    q: (B, Hq, n, D); k: (B, Hkv, n, D); v: (B, Hkv, n, Dv), with per-row
    start offsets from ``state.t`` (slots verify at their own depths).  An
    int8 ``QuantizedPool`` carry-in is dequantized once here; the window
    runs in fp32 whatever q's dtype.  Strict competition only.

    Returns ``(out, traj)``: ``out`` (B, Hq, n, Dv) in q's dtype, position
    j what ``decode_step`` emits after tokens 1..j (up to fp32 order), and
    ``traj`` a ``FlowState`` whose leaves carry the window axis at index 1
    (``t`` (B, n); sums (B, n, Hkv, D); ``z`` (B, n, Hkv); ``s`` (B, n,
    Hkv, D, Dv)).  A window is a handful of tokens, so the aggregation is
    a cumsum of rank-1 updates on the carried ``s``, with no causal dot.
    """
    from repro_torch.attention.recurrent import FlowState  # lazy: cycle
    from repro_torch.serving.quant import QuantizedPool, dequantize_state

    if isinstance(state, QuantizedPool):
        # quantized pools verify in full precision: one dequantize here;
        # the caller carries the pool's recipe beside the fp32 trajectory
        # (``serving.quant.QuantTraj``), so rollback quantizes once
        state = dequantize_state(state)
    out_dtype = q.dtype
    eps = cfg.eps
    n = q.shape[2]
    if k.shape[2] != n:
        raise ValueError("verify requires N == M over the window")
    if not (cfg.strict_causal and cfg.use_competition):
        raise ValueError("verify continues a recurrent state: requires "
                         "strict_causal competition")
    k, v = expand_kv(q, k, v, cfg)
    hkv = k.shape[1]

    phi_q = phi_map(q.float(), cfg.phi)
    phi_k = phi_map(k.float(), cfg.phi)
    vf = v.float()

    qg = _group(phi_q, hkv)  # (B,Hkv,G,n,D)
    g = qg.shape[2]

    # per-row position counts continue from the carried state.t
    t_traj = state.t[:, None] + torch.arange(
        1, n + 1, dtype=torch.int32, device=q.device)  # (B,n)
    normal_k = t_traj.float()[:, None, :]  # (B,1,n) sources seen so far
    normal_q = normal_k * g  # sinks seen so far (G per position)

    # (1) incoming / outgoing flows: window cumsums offset by the carry
    k_csum = state.k_sum[:, :, None, :] + torch.cumsum(phi_k, dim=2)
    q_csum = state.q_sum[:, :, None, :] + torch.cumsum(qg.sum(dim=2), dim=2)
    sink_in = normal_k[:, :, None, :] / torch.einsum(
        "bhgnd,bhnd->bhgn", qg + eps, k_csum + eps)
    src_out = normal_q / torch.einsum("bhnd,bhnd->bhn", phi_k + eps,
                                      q_csum + eps)

    # (2) conservation refinement
    ko_csum = state.ko_sum[:, :, None, :] + torch.cumsum(
        phi_k * src_out[..., None], dim=2)
    cons_sink = torch.einsum("bhgnd,bhnd->bhgn", qg + eps,
                             ko_csum + eps) / normal_q[:, :, None, :]
    qi_csum = state.qi_sum[:, :, None, :] + torch.cumsum(
        (qg * sink_in[..., None]).sum(dim=2), dim=2)
    cons_src = torch.einsum("bhnd,bhnd->bhn", phi_k + eps,
                            qi_csum + eps) / normal_k
    cons_src = cons_src.clamp(-1.0, 1.0)

    # (3) competition & allocation
    alloc = (torch.sigmoid(cons_sink) if cfg.use_allocation
             else torch.ones_like(cons_sink))
    e = torch.exp(cons_src)  # (B,Hkv,n)
    z = state.z[:, :, None] + torch.cumsum(e, dim=-1)
    v_w = vf * e[..., None]

    # (4) aggregation against the per-position state panel: the window is
    # a handful of tokens, and rollback needs the trajectory anyway
    s_traj = state.s[:, :, None] + torch.cumsum(
        torch.einsum("bhnd,bhne->bhnde", phi_k, v_w), dim=2)
    q_in = qg * sink_in[..., None]
    agg = torch.einsum("bhgnd,bhnde->bhgne", q_in, s_traj)
    scale = normal_k[:, :, None, :, None] / z[:, :, None, :, None]
    out = agg * scale * alloc[..., None]

    traj = FlowState(
        t=t_traj,
        q_sum=q_csum.transpose(1, 2), k_sum=k_csum.transpose(1, 2),
        ko_sum=ko_csum.transpose(1, 2), qi_sum=qi_csum.transpose(1, 2),
        z=z.transpose(1, 2), s=s_traj.transpose(1, 2))
    return _ungroup(out).to(out_dtype), traj
