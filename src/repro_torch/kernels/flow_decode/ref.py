"""Plain PyTorch versions of the flow_decode kernels at their flat shapes.

The math is ``attention/recurrent.py::decode_step``; the flat (BH, ...)
layout is its (B, Hkv, ...) layout with B = BH and one kv head per row.
``flow_decode_ref`` is K3's plain version (fp32 pool), ``flow_decode_q_ref``
K4's (int8 pool: dequantize, the same fp32 step, requantize), and
``flow_decode_split`` and ``flow_decode_q_split`` K3's and K4's algebra in
the order their kernels take it.
"""
from __future__ import annotations

import torch

from repro_torch.attention.recurrent import FlowState, decode_step
from repro_torch.core.flow_attention import FlowConfig, phi_map


def flow_decode_ref(t, q, k, v, k_sum, q_sum, ko_sum, qi_sum, z, s, *,
                    hkv: int, eps: float = 1e-6, phi: str = "sigmoid",
                    use_alloc: bool = True):
    """One decode step; pure (returns new tensors).

    t: (B,) int32 count AFTER this token; q: (BH, G, D); k: (BH, D);
    v: (BH, Dv); sums (BH, D), z (BH,), s (BH, D, Dv) fp32, BH = B * hkv.
    Returns (out (BH, G, Dv), (k_sum, q_sum, ko_sum, qi_sum, z, s)).
    """
    cfg = FlowConfig(eps=eps, phi=phi, causal=True, strict_causal=True,
                     use_allocation=use_alloc)
    state = FlowState(t=t.repeat_interleave(hkv) - 1, q_sum=q_sum[:, None],
                      k_sum=k_sum[:, None], ko_sum=ko_sum[:, None],
                      qi_sum=qi_sum[:, None], z=z[:, None], s=s[:, None])
    new, out = decode_step(state, q[:, :, None], k[:, None, None],
                           v[:, None, None], cfg)
    return out[:, :, 0], (new.k_sum[:, 0], new.q_sum[:, 0], new.ko_sum[:, 0],
                          new.qi_sum[:, 0], new.z[:, 0], new.s[:, 0])


def _split_step(t, q, k, v, k_sum, q_sum, ko_sum, qi_sum, z, s_in, *,
                hkv: int, eps: float, phi: str, use_alloc: bool):
    """The fp32 step as ``csrc/flow_decode.cu`` and ``flow_decode_q.cu``
    take it, from an fp32 state; returns (out in fp32, (k_sum, q_sum,
    ko_sum, qi_sum, z, s))."""
    f32 = torch.float32
    pq = phi_map(q.to(f32), phi)  # (BH, G, D)
    pk = phi_map(k.to(f32), phi)  # (BH, D)
    g = q.shape[1]
    tf = t.repeat_interleave(hkv).to(f32)  # (BH,) counts after the token
    k_sum = k_sum + pk
    q_sum = q_sum + pq.sum(1)
    sink = tf[:, None] / torch.einsum("bgd,bd->bg", pq + eps, k_sum + eps)
    src = tf * g / torch.einsum("bd,bd->b", pk + eps, q_sum + eps)
    ko_sum = ko_sum + pk * src[:, None]
    qi_sum = qi_sum + (pq * sink[..., None]).sum(1)
    cons_sink = torch.einsum("bgd,bd->bg", pq + eps,
                             ko_sum + eps) / (tf * g)[:, None]
    alloc = torch.sigmoid(cons_sink) if use_alloc else torch.ones_like(
        cons_sink)
    cons_src = torch.einsum("bd,bd->b", pk + eps, qi_sum + eps) / tf
    e = torch.exp(cons_src.clamp(-1.0, 1.0))
    z_new = z + e
    ve = v.to(f32) * e[:, None]
    s_new = s_in + pk[:, :, None] * ve[:, None, :]
    agg = sink[..., None] * (torch.einsum("bgd,bde->bge", pq, s_in)
                             + torch.einsum("bgd,bd->bg", pq, pk)[..., None]
                             * ve[:, None, :])
    out = agg * (tf / z_new)[:, None, None] * alloc[..., None]
    return out, (k_sum, q_sum, ko_sum, qi_sum, z_new, s_new)


def flow_decode_split(t, q, k, v, k_sum, q_sum, ko_sum, qi_sum, z, s, *,
                      hkv: int, eps: float = 1e-6, phi: str = "sigmoid",
                      use_alloc: bool = True):
    """``flow_decode_ref`` with the output taken as ``csrc/flow_decode.cu``
    takes it; the same arguments and results.

    The flows are the same fp32 recurrence.  The output does not wait for
    the new state: out_g = sink_g (phi(q)_g @ S + (phi(q)_g . phi(k))
    (v e)) (t / z) alloc_g, the same value as q_in_g @ S_new in another fp32
    order.  S_new = S + phi(k) (v e)^T is formed elementwise.
    """
    out, new = _split_step(t, q, k, v, k_sum, q_sum, ko_sum, qi_sum, z, s,
                           hkv=hkv, eps=eps, phi=phi, use_alloc=use_alloc)
    return out.to(q.dtype), new


_SCALE_EPS = 1e-12  # serving.quant's amax floor


def _requant(x, qmax: float):
    """Fresh-amax int8 quantize of each flat row (every axis but the first
    reduces), as ``repro/kernels/flow_decode/quant.py::_requant`` does per
    program: scale = max(amax, 1e-12) / qmax; payload = rint(clip(x / scale)).
    """
    amax = x.abs().amax(dim=tuple(range(1, x.ndim)), keepdim=True)
    sc = amax.clamp(min=_SCALE_EPS) / torch.full_like(amax, qmax)  # IEEE
    payload = torch.round((x / sc).clamp(-qmax, qmax)).to(torch.int8)
    return payload, sc.reshape(x.shape[0], 1)


def flow_decode_q_ref(t, q, k, v, sum_payloads, s_payload, sum_scales, s_scale,
                      z, *, hkv: int, eps: float = 1e-6, phi: str = "sigmoid",
                      use_alloc: bool = True, qmax: float = 127.0):
    """One decode step on an int8 pool; pure (returns new tensors).

    t: (B,) int32 count AFTER this token; q: (BH, G, D); k: (BH, D);
    v: (BH, Dv); ``sum_payloads`` the (k, q, ko, qi) sums' int8 payloads
    (BH, D) and ``sum_scales`` their fp32 scales (BH, 1), in that order;
    s_payload (BH, D, Dv) int8, s_scale (BH, 1) fp32; z (BH,) raw fp32.
    Dequantizes (payload * scale), runs ``flow_decode_ref`` in fp32, and
    requantizes each of the five leaves with a fresh amax.  Returns
    (out (BH, G, Dv), (k, q, ko, qi) payloads, s payload, (k, q, ko, qi)
    scales, s scale, z).
    """
    sums = [p.float() * s for p, s in zip(sum_payloads, sum_scales)]
    s_in = s_payload.float() * s_scale[:, :, None]
    out, (k_sum, q_sum, ko_sum, qi_sum, z_new, s_new) = flow_decode_ref(
        t, q, k, v, *sums, z, s_in, hkv=hkv, eps=eps, phi=phi,
        use_alloc=use_alloc)
    pairs = [_requant(x, qmax) for x in (k_sum, q_sum, ko_sum, qi_sum)]
    s_pay, s_sc = _requant(s_new, qmax)
    return (out, tuple(p for p, _ in pairs), s_pay, tuple(s for _, s in pairs),
            s_sc, z_new)


def flow_decode_q_split(t, q, k, v, sum_payloads, s_payload, sum_scales,
                        s_scale, z, *, hkv: int, eps: float = 1e-6,
                        phi: str = "sigmoid", use_alloc: bool = True,
                        qmax: float = 127.0):
    """``flow_decode_q_ref`` with the output taken as ``csrc/flow_decode_q.cu``
    takes it; the same arguments and results.

    The flows are the same fp32 recurrence.  The output does not wait for
    the new state: out_g = sink_g (phi(q)_g @ deq(S) + (phi(q)_g . phi(k))
    (v e)) (t / z) alloc_g, the same value as q_in_g @ S_new in another fp32
    order.  S_new = deq(S) + phi(k) (v e)^T is formed elementwise, and the
    five leaves are requantized as before.
    """
    k_sum, q_sum, ko_sum, qi_sum = (p.float() * s for p, s in
                                    zip(sum_payloads, sum_scales))
    s_in = s_payload.float() * s_scale[:, :, None]
    out, (k_sum, q_sum, ko_sum, qi_sum, z_new, s_new) = _split_step(
        t, q, k, v, k_sum, q_sum, ko_sum, qi_sum, z, s_in, hkv=hkv, eps=eps,
        phi=phi, use_alloc=use_alloc)
    pairs = [_requant(x, qmax) for x in (k_sum, q_sum, ko_sum, qi_sum)]
    s_pay, s_sc = _requant(s_new, qmax)
    return (out.to(q.dtype), tuple(p for p, _ in pairs), s_pay,
            tuple(s for _, s in pairs), s_sc, z_new)
