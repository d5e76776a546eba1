"""O(d^2) recurrent decoding for strictly-causal Flow-Attention.

The counterpart of ``repro/attention/recurrent.py``.  The whole per-head
"KV cache" of a Flowformer is

    q_sum, k_sum, ko_sum, qi_sum : (B, Hkv, D)     running flow sums
    z                            : (B, Hkv)        competition normalizer
    s                            : (B, Hkv, D, Dv) aggregation state
    t                            : (B,) int32      positions consumed

independent of context length.  The state is fp32 whatever the activation
dtype.  ``decode_step`` here is the plain PyTorch version of the decode
kernel (``kernels/flow_decode``); it is pure and allocates a new state.
``forward_by_scan`` runs it token by token (the oracle of the ``recurrent``
backend's forward and prefill), and ``select_state`` gathers one boundary
per row from a verify trajectory (speculative rollback).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.flow_attention import FlowConfig, _group, phi_map


class FlowState(NamedTuple):
    t: torch.Tensor  # (B,) int32 — positions consumed per batch row
    q_sum: torch.Tensor  # (B, Hkv, D) fp32
    k_sum: torch.Tensor  # (B, Hkv, D) fp32
    ko_sum: torch.Tensor  # (B, Hkv, D) fp32
    qi_sum: torch.Tensor  # (B, Hkv, D) fp32
    z: torch.Tensor  # (B, Hkv) fp32
    s: torch.Tensor  # (B, Hkv, D, Dv) fp32


def init_state(batch: int, n_kv: int, d: int, dv: int | None = None, *,
               device=None) -> FlowState:
    dv = d if dv is None else dv
    f32 = torch.float32
    return FlowState(
        t=torch.zeros((batch,), dtype=torch.int32, device=device),
        q_sum=torch.zeros((batch, n_kv, d), dtype=f32, device=device),
        k_sum=torch.zeros((batch, n_kv, d), dtype=f32, device=device),
        ko_sum=torch.zeros((batch, n_kv, d), dtype=f32, device=device),
        qi_sum=torch.zeros((batch, n_kv, d), dtype=f32, device=device),
        z=torch.zeros((batch, n_kv), dtype=f32, device=device),
        s=torch.zeros((batch, n_kv, d, dv), dtype=f32, device=device),
    )


def gather_boundary(leaf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row b of ``leaf`` (B, n, ...) at window position ``idx[b]``, as a
    contiguous (B, ...) tensor (the decode kernels want their pools
    contiguous)."""
    ii = idx.to(device=leaf.device, dtype=torch.long).reshape(
        (-1,) + (1,) * (leaf.ndim - 1))
    return torch.take_along_dim(leaf, ii, dim=1)[:, 0].contiguous()


def select_state(traj: FlowState, idx: torch.Tensor) -> FlowState:
    """Gather one boundary per batch row from a trajectory ``FlowState``.

    ``traj`` leaves carry a position axis at index 1 (as returned by
    ``pipeline.causal_verify``); ``idx`` (B,) int selects, per row, the
    boundary after consuming ``idx + 1`` window tokens.  This is the whole
    accept-prefix rollback: a gather, nothing recomputed.
    """
    return FlowState(*(gather_boundary(leaf, idx) for leaf in traj))


def decode_step(state: FlowState, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, cfg: FlowConfig):
    """Advance one token.

    q: (B, Hq, 1, D); k: (B, Hkv, 1, D); v: (B, Hkv, 1, Dv).
    Returns (new_state, out (B, Hq, 1, Dv)).
    """
    eps = cfg.eps
    b, hq, one, d = q.shape
    if one != 1:
        raise ValueError("decode_step consumes exactly one position")
    hkv = k.shape[1]
    f32 = torch.float32

    phi_q = phi_map(q.to(f32), cfg.phi)  # (B,Hq,1,D)
    phi_k = phi_map(k.to(f32), cfg.phi)[:, :, 0, :]  # (B,Hkv,D)
    vf = v.to(f32)[:, :, 0, :]  # (B,Hkv,Dv)

    qg = _group(phi_q, hkv)[:, :, :, 0, :]  # (B,Hkv,G,D)
    g = qg.shape[2]

    t = state.t + 1  # (B,)
    tf = t.to(f32)[:, None, None]  # (B,1,1) per-slot counts
    normal_k = tf  # sources seen so far
    normal_q = tf * g  # sinks seen so far (G per position)

    k_sum = state.k_sum + phi_k
    q_sum = state.q_sum + qg.sum(dim=2)

    sink_in = normal_k / torch.einsum("bhgd,bhd->bhg", qg + eps, k_sum + eps)
    src_out = normal_q[:, :, 0] / torch.einsum("bhd,bhd->bh", phi_k + eps,
                                               q_sum + eps)

    ko_sum = state.ko_sum + phi_k * src_out[..., None]
    cons_sink = torch.einsum("bhgd,bhd->bhg", qg + eps, ko_sum + eps) / normal_q

    qi_sum = state.qi_sum + (qg * sink_in[..., None]).sum(dim=2)
    cons_src = torch.einsum("bhd,bhd->bh", phi_k + eps,
                            qi_sum + eps) / normal_k[:, :, 0]
    cons_src = cons_src.clamp(-1.0, 1.0)

    alloc = (torch.sigmoid(cons_sink) if cfg.use_allocation
             else torch.ones_like(cons_sink))

    e = torch.exp(cons_src)  # (B,Hkv)
    z = state.z + e
    s = state.s + torch.einsum("bhd,bhe->bhde", phi_k, vf * e[..., None])

    q_in = qg * sink_in[..., None]  # (B,Hkv,G,D)
    agg = torch.einsum("bhgd,bhde->bhge", q_in, s)
    out = agg * (normal_k[:, :, 0] / z)[:, :, None, None] * alloc[..., None]
    out = out.reshape(b, hq, 1, -1).to(q.dtype)

    new_state = FlowState(t=t, q_sum=q_sum, k_sum=k_sum, ko_sum=ko_sum,
                          qi_sum=qi_sum, z=z, s=s)
    return new_state, out


def forward_by_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: FlowConfig, *, return_state: bool = False):
    """Token-by-token forward through ``decode_step`` (an oracle for tiny
    shapes: O(N) sequential steps, never the fast path).

    q: (B, Hq, N, D); k: (B, Hkv, N, D); v: (B, Hkv, N, Dv).  Returns out
    (B, Hq, N, Dv), and the final ``FlowState`` with ``return_state``.
    """
    b, _, n, d = q.shape
    state = init_state(b, k.shape[1], d, v.shape[-1], device=q.device)
    outs = []
    for j in range(n):
        state, out = decode_step(state, q[:, :, j:j + 1], k[:, :, j:j + 1],
                                 v[:, :, j:j + 1], cfg)
        outs.append(out)
    out = torch.cat(outs, dim=2)
    return (out, state) if return_state else out
