"""Plain PyTorch versions of the flow_decode kernels at their flat shapes.

The math is ``attention/recurrent.py::decode_step``; the flat (BH, ...)
layout is its (B, Hkv, ...) layout with B = BH and one kv head per row.
``flow_decode_ref`` is K3's plain version (fp32 pool), ``flow_decode_q_ref``
K4's (int8 pool: dequantize, the same fp32 step, requantize).
"""
from __future__ import annotations

import torch

from repro_torch.attention.recurrent import FlowState, decode_step
from repro_torch.core.flow_attention import FlowConfig


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
