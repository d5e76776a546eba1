"""Fused strict-causal Flow-Attention: one chunked scan over the sequence.

The counterpart of ``repro/attention/fused.py`` and the plain PyTorch
version of the flow_fused kernel (``kernels/flow_fused``).  Per chunk c:

    k/q running sums -> sink_in, src_out          (C-local cumsums + carry)
    ko/qi running sums -> cons_sink, cons_src     (conservation, Eq. 7)
    e = exp(clip(cons_src)); z += cumsum(e)       (cumulative competition)
    v_w = V * e
    out_c = [tril(Q'_c K_c^T) v_w + Q'_c S] * (pos/z) * alloc
    S += K_c^T v_w                                (carried (D, Dv) state)

The carry is the O(d^2) ``FlowState`` that decode continues from, so a
prefill hands serving its state with no extra pass.
"""
from __future__ import annotations

import torch

from repro_torch.attention.recurrent import FlowState
from repro_torch.core.flow_attention import FlowConfig, _group, _ungroup, phi_map


def effective_chunk(n: int, chunk_size: int) -> int:
    """Chunk size actually used for a length-``n`` sequence: ``chunk_size``
    capped at ``n``.  Other lengths are padded to the next chunk multiple
    and the tail is masked (see ``padded_len``)."""
    return max(1, min(chunk_size, n))


def padded_len(n: int, chunk: int) -> int:
    """``n`` rounded up to the next multiple of ``chunk``."""
    return -(-n // chunk) * chunk


def pad_seq(x: torch.Tensor, n_pad: int, dim: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``dim`` to length ``n_pad``."""
    n = x.shape[dim]
    if n == n_pad:
        return x
    shape = list(x.shape)
    shape[dim] = n_pad - n
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def fused_causal_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cfg: FlowConfig, *, return_state: bool = False,
                         lengths: torch.Tensor | None = None):
    """Strict-causal Flow-Attention in one fused chunked scan.

    q: (B, Hq, N, D); k: (B, Hkv, N, D); v: (B, Hkv, N, Dv).  Implements
    shared-GQA semantics over the kv heads it is given.

    ``lengths`` (B,) selects packed-prefill semantics: positions past each
    row's length contribute zero phi and e, so every running sum freezes at
    the boundary and the final carry is that row's boundary ``FlowState``.
    """
    if not (cfg.strict_causal and cfg.use_competition):
        raise ValueError("fused path implements the strict-causal "
                         "cumulative competition")
    out_dtype = q.dtype
    eps = cfg.eps
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    dv = v.shape[-1]
    if k.shape[2] != n:
        raise ValueError("causal flow attention requires N == M")
    dev = q.device
    f32 = torch.float32

    c = effective_chunk(n, cfg.chunk_size)
    n_pad = padded_len(n, c)
    nc = n_pad // c

    if lengths is None:
        t = torch.full((b,), n, dtype=torch.int32, device=dev)
    else:
        t = lengths.to(device=dev, dtype=torch.int32).clamp(1, n)
    # (B, n_pad) validity: padding tail and packed positions both masked
    row_ok = (torch.arange(n_pad, device=dev)[None, :] < t[:, None]).to(f32)

    phi_q = phi_map(pad_seq(q, n_pad, 2).to(f32), cfg.phi)
    phi_k = phi_map(pad_seq(k, n_pad, 2).to(f32), cfg.phi)
    phi_q = phi_q * row_ok[:, None, :, None]
    phi_k = phi_k * row_ok[:, None, :, None]
    vf = pad_seq(v, n_pad, 2).to(f32)

    qg = _group(phi_q, hkv)  # (B,Hkv,G,n_pad,D)
    g = qg.shape[2]
    qs = qg.reshape(b, hkv, g, nc, c, d)
    ks = phi_k.reshape(b, hkv, nc, c, d)
    vs = vf.reshape(b, hkv, nc, c, dv)
    # 1-based global positions per chunk: (nc, c)
    pos = (torch.arange(n_pad, dtype=f32, device=dev) + 1.0).reshape(nc, c)
    oks = row_ok.reshape(b, nc, c)
    mask = torch.tril(torch.ones((c, c), dtype=f32, device=dev))

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=dev)

    q_sum, k_sum, ko_sum, qi_sum = (zeros(b, hkv, d) for _ in range(4))
    z = zeros(b, hkv)
    s = zeros(b, hkv, d, dv)
    outs = []
    for ci in range(nc):
        qc, kc, vc = qs[:, :, :, ci], ks[:, :, ci], vs[:, :, ci]
        p, ok = pos[ci], oks[:, ci]
        normal_k = p  # sources seen up to position i
        normal_q = p * g  # sinks seen (G per position)

        # (1) flows from carried sums + chunk-local inclusive cumsums
        k_csum = k_sum[:, :, None] + torch.cumsum(kc, dim=2)  # (B,H,c,d)
        q_csum = q_sum[:, :, None] + torch.cumsum(qc.sum(dim=2), dim=2)
        sink_in = normal_k / torch.einsum("bhgnd,bhnd->bhgn", qc + eps,
                                          k_csum + eps)
        src_out = normal_q / torch.einsum("bhnd,bhnd->bhn", kc + eps,
                                          q_csum + eps)

        # (2) conservation refinement
        ko_csum = ko_sum[:, :, None] + torch.cumsum(kc * src_out[..., None],
                                                    dim=2)
        cons_sink = torch.einsum("bhgnd,bhnd->bhgn", qc + eps,
                                 ko_csum + eps) / normal_q
        qi_csum = qi_sum[:, :, None] + torch.cumsum(
            (qc * sink_in[..., None]).sum(dim=2), dim=2)
        cons_src = (torch.einsum("bhnd,bhnd->bhn", kc + eps, qi_csum + eps)
                    / normal_k).clamp(-1.0, 1.0)

        # (3) cumulative competition + allocation; e masked past each
        # row's boundary so z freezes with the sums
        alloc = (torch.sigmoid(cons_sink) if cfg.use_allocation
                 else torch.ones_like(cons_sink))
        e = torch.exp(cons_src) * ok[:, None, :]
        zc = z[:, :, None] + torch.cumsum(e, dim=2)  # (B,H,c)
        v_w = vc * e[..., None]

        # (4) aggregation: intra-chunk tril matmul + carried (D,Dv) state
        q_in = qc * sink_in[..., None]
        scores = torch.einsum("bhgid,bhjd->bhgij", q_in, kc)
        intra = torch.einsum("bhgij,bhje->bhgie", scores * mask, v_w)
        inter = torch.einsum("bhgid,bhde->bhgie", q_in, s)
        out = (intra + inter) * (normal_k / zc)[:, :, None, :, None]
        outs.append((out * alloc[..., None]).to(out_dtype))

        q_sum, k_sum = q_csum[:, :, -1], k_csum[:, :, -1]
        ko_sum, qi_sum = ko_csum[:, :, -1], qi_csum[:, :, -1]
        z = zc[:, :, -1]
        s = s + torch.einsum("bhjd,bhje->bhde", kc, v_w)

    out = _ungroup(torch.cat(outs, dim=3))[:, :, :n]
    if return_state:
        return out, FlowState(t=t, q_sum=q_sum, k_sum=k_sum, ko_sum=ko_sum,
                              qi_sum=qi_sum, z=z, s=s)
    return out
