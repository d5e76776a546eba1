"""Plain PyTorch version of the flow_decode kernel at its flat shapes.

The math is ``attention/recurrent.py::decode_step``; the flat (BH, ...)
layout is its (B, Hkv, ...) layout with B = BH and one kv head per row.
"""
from __future__ import annotations

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
