"""Wrappers of the flow_decode CUDA kernels (``csrc/flow_decode.cu``, K3,
and ``csrc/flow_decode_q.cu``, K4).

``flow_decode_call`` works on the kernel's flat (BH, ...) layout and
updates the six state tensors in place; ``flow_decode_step`` views a
(B, Hkv, ...) ``FlowState`` pool and a (B, Hq, 1, D) token that way, as
``repro/kernels/flow_decode/ops.py`` does around the TPU kernel;
``flow_decode_q_step`` does the same for an int8 ``QuantizedPool`` around
K4 (``quant.py::flow_decode_q_call``).  The state
must be contiguous fp32 views of the pool: the wrapper never copies it,
since a copy would silently drop the in-place update.  CPU tensors run the
plain version (``ref.py``) and copy its result into the state; CUDA
tensors launch the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.attention.recurrent import FlowState
from repro_torch.core.flow_attention import FlowConfig
from repro_torch.kernels import _lib
from repro_torch.kernels._lib import DTYPE_CODES, HEAD_DIMS, LAUNCHES, PHI_CODES
from repro_torch.kernels.flow_decode.quant import flow_decode_q_call
from repro_torch.kernels.flow_decode.ref import flow_decode_ref

__all__ = ["LAUNCHES", "flow_decode_call", "flow_decode_q_step",
           "flow_decode_step"]

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                            ctypes.c_void_p]


def flow_decode_call(t, q, k, v, k_sum, q_sum, ko_sum, qi_sum, z, s, *,
                     hkv: int, eps: float = 1e-6, phi: str = "sigmoid",
                     use_alloc: bool = True) -> torch.Tensor:
    """Advance every (slot, kv head) by one token, state in place.

    t: (B,) int32 count AFTER this token; q: (BH, G, D); k: (BH, D);
    v: (BH, Dv); k/q/ko/qi sums (BH, D), z (BH,), s (BH, D, Dv) fp32 with
    BH = B * hkv.  Returns out (BH, G, Dv) in q's dtype.
    """
    state = (k_sum, q_sum, ko_sum, qi_sum, z, s)
    bh, g, d = q.shape
    dv = v.shape[-1]
    if q.device.type == "cpu":
        out, new = flow_decode_ref(t, q, k, v, *state, hkv=hkv, eps=eps,
                                   phi=phi, use_alloc=use_alloc)
        for dst, src in zip(state, new):
            dst.copy_(src)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"flow_decode runs on cuda or cpu, not {q.device}")
    names = ("t", "k", "v", "k_sum", "q_sum", "ko_sum", "qi_sum", "z", "s")
    for name, x in zip(names, (t, k, v, *state)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    for name, x in zip(("q",) + names, (q, t, k, v, *state)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous (state: a view of "
                             "the pool, never a copy)")
    for name, x in zip(("q", "k", "v", "k_sum", "q_sum", "ko_sum", "qi_sum",
                        "s"), (q, k, v, *state[:4], state[5])):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel's "
                             "vector loads)")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share fp32 or bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if any(x.dtype != torch.float32 for x in state):
        raise ValueError("the FlowState pool must be fp32")
    if t.dtype != torch.int32 or bh % hkv or t.shape != (bh // hkv,):
        raise ValueError(f"t must be int32 of shape ({bh // hkv},)")
    want = {"k": (bh, d), "v": (bh, dv), "k_sum": (bh, d), "q_sum": (bh, d),
            "ko_sum": (bh, d), "qi_sum": (bh, d), "z": (bh,), "s": (bh, d, dv)}
    for name, x in zip(names[1:], (k, v, *state)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"want {want[name]}")
    if d != dv or d not in HEAD_DIMS:
        raise ValueError(f"kernel takes D == Dv in {HEAD_DIMS}, got {d}/{dv}")
    if phi not in PHI_CODES:
        raise ValueError(f"unknown phi {phi!r}")

    out = torch.empty((bh, g, dv), dtype=q.dtype, device=q.device)
    fn = _lib.function("flow_decode", "flow_decode_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(t.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             *(x.data_ptr() for x in state), out.data_ptr(), bh, hkv, g, d,
             dv, DTYPE_CODES[q.dtype], PHI_CODES[phi], int(use_alloc), eps,
             stream)
    _lib.check(fn, err, "flow_decode")
    LAUNCHES["flow_decode"] += 1
    return out


def flow_decode_step(state: FlowState, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, cfg: FlowConfig):
    """Advance one token for every slot, updating ``state`` in place.

    q: (B, Hq, 1, D); k: (B, Hkv, 1, D); v: (B, Hkv, 1, Dv).  Returns
    ``(state, out (B, Hq, 1, Dv))`` where ``state`` holds the very tensors
    it was given.  Every slot advances, live or not, as in the reference.
    """
    b, hq, one, d = q.shape
    if one != 1:
        raise ValueError("decode_step consumes exactly one position")
    hkv = k.shape[1]
    g = hq // hkv
    dv = v.shape[-1]
    bh = b * hkv
    state.t.add_(1)  # per-slot counts after this token
    out = flow_decode_call(
        state.t, q.reshape(bh, g, d).contiguous(),
        k.reshape(bh, d).contiguous(), v.reshape(bh, dv).contiguous(),
        state.k_sum.view(bh, d), state.q_sum.view(bh, d),
        state.ko_sum.view(bh, d), state.qi_sum.view(bh, d),
        state.z.view(bh), state.s.view(bh, d, dv),
        hkv=hkv, eps=cfg.eps, phi=cfg.phi, use_alloc=cfg.use_allocation)
    return state, out.reshape(b, hq, 1, dv)


def flow_decode_q_step(pool, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, cfg: FlowConfig):
    """Advance one token for every slot of an int8 ``QuantizedPool``, in
    place (K4).

    ``pool`` is a ``serving.quant.QuantizedPool`` whose payload and scale
    trees are FlowStates (head granularity, ``z`` exempt), as
    ``repro/kernels/flow_decode/ops.py::flow_decode_q_step`` takes it.
    q: (B, Hq, 1, D); k: (B, Hkv, 1, D); v: (B, Hkv, 1, Dv).  Returns
    ``(pool, out (B, Hq, 1, Dv))`` where ``pool`` holds the very tensors it
    was given.  Every slot advances, live or not.
    """
    if pool.granularity != "head" or pool.exempt != ("z",):
        raise ValueError(
            "flow_decode_q_step expects the serving FlowState pool recipe "
            f"(head granularity, z exempt); got {pool.granularity!r}/"
            f"{pool.exempt!r}")
    st, sc = pool.payload, pool.scale
    b, hq, one, d = q.shape
    if one != 1:
        raise ValueError("decode_step consumes exactly one position")
    hkv = k.shape[1]
    g = hq // hkv
    dv = v.shape[-1]
    bh = b * hkv
    st.t.add_(1)  # per-slot counts after this token
    out = flow_decode_q_call(
        st.t, q.reshape(bh, g, d).contiguous(),
        k.reshape(bh, d).contiguous(), v.reshape(bh, dv).contiguous(),
        (st.k_sum.view(bh, d), st.q_sum.view(bh, d), st.ko_sum.view(bh, d),
         st.qi_sum.view(bh, d)), st.s.view(bh, d, dv),
        (sc.k_sum.view(bh, 1), sc.q_sum.view(bh, 1), sc.ko_sum.view(bh, 1),
         sc.qi_sum.view(bh, 1)), sc.s.view(bh, 1), st.z.view(bh),
        hkv=hkv, eps=cfg.eps, phi=cfg.phi, use_alloc=cfg.use_allocation)
    return pool, out.reshape(b, hq, 1, dv)
