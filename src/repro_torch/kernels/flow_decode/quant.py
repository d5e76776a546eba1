"""Wrapper of the flow_decode_q CUDA kernel (``csrc/flow_decode_q.cu``, K4).

``flow_decode_q_call`` works on the kernel's flat (BH, ...) layout of an
int8 FlowState pool and updates payloads, scales and ``z`` in place, as
``repro/kernels/flow_decode/quant.py::flow_decode_q_call`` does by aliasing
on the TPU.  The pool's tensors must be contiguous views of the Worker's
pool: the wrapper never copies them, since a copy would silently drop the
in-place update.  CPU tensors run the plain version (``ref.py::
flow_decode_q_ref``) and copy its result into the pool; CUDA tensors
launch the kernel.  Only int8 payloads are taken: fp8 pools are refused
off the TPU by the registries before any kernel is chosen.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._lib import DTYPE_CODES, HEAD_DIMS, LAUNCHES, PHI_CODES
from repro_torch.kernels.flow_decode.ref import flow_decode_q_ref

__all__ = ["LAUNCHES", "flow_decode_q_call"]

_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                            ctypes.c_void_p]


def flow_decode_q_call(t, q, k, v, sum_payloads, s_payload, sum_scales,
                       s_scale, z, *, hkv: int, eps: float = 1e-6,
                       phi: str = "sigmoid",
                       use_alloc: bool = True) -> torch.Tensor:
    """Advance every (slot, kv head) of an int8 pool by one token, in place.

    t: (B,) int32 count AFTER this token; q: (BH, G, D); k: (BH, D);
    v: (BH, Dv); ``sum_payloads`` the (k, q, ko, qi) sums' int8 payloads
    (BH, D) and ``sum_scales`` their fp32 scales (BH, 1), in that order;
    s_payload (BH, D, Dv) int8; s_scale (BH, 1) fp32; z (BH,) fp32; with
    BH = B * hkv.  Returns out (BH, G, Dv) in q's dtype.
    """
    pays = (*sum_payloads, s_payload)
    scales = (*sum_scales, s_scale)
    bh, g, d = q.shape
    dv = v.shape[-1]
    if q.device.type == "cpu":
        out, new_pays, new_s_pay, new_scs, new_s_sc, new_z = flow_decode_q_ref(
            t, q, k, v, sum_payloads, s_payload, sum_scales, s_scale, z,
            hkv=hkv, eps=eps, phi=phi, use_alloc=use_alloc)
        for dst, src in zip(pays + scales + (z,),
                            (*new_pays, new_s_pay, *new_scs, new_s_sc, new_z)):
            dst.copy_(src)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"flow_decode_q runs on cuda or cpu, not {q.device}")
    names = ("t", "k", "v", "k_pay", "q_pay", "ko_pay", "qi_pay", "s_pay",
             "k_scale", "q_scale", "ko_scale", "qi_scale", "s_scale", "z")
    tensors = (t, k, v, *pays, *scales, z)
    for name, x in zip(names, tensors):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    for name, x in zip(("q",) + names, (q,) + tensors):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous (pool: a view of the "
                             "Worker's pool, never a copy)")
    for name, x in zip(("q",) + names[1:8], (q,) + tensors[1:8]):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel's "
                             "vector loads)")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share fp32 or bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if any(x.dtype != torch.int8 for x in pays):
        raise ValueError("flow_decode_q takes int8 payloads only, got "
                         f"{sorted({str(x.dtype) for x in pays})}")
    if any(x.dtype != torch.float32 for x in scales + (z,)):
        raise ValueError("the pool's scales and z must be fp32")
    if t.dtype != torch.int32 or bh % hkv or t.shape != (bh // hkv,):
        raise ValueError(f"t must be int32 of shape ({bh // hkv},)")
    want = {"k": (bh, d), "v": (bh, dv), "s_pay": (bh, d, dv), "z": (bh,)}
    want.update(dict.fromkeys(("k_pay", "q_pay", "ko_pay", "qi_pay"), (bh, d)))
    want.update(dict.fromkeys(names[8:13], (bh, 1)))
    for name, x in zip(names[1:], tensors[1:]):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"want {want[name]}")
    if d != dv or d not in HEAD_DIMS:
        raise ValueError(f"kernel takes D == Dv in {HEAD_DIMS}, got {d}/{dv}")
    if phi not in PHI_CODES:
        raise ValueError(f"unknown phi {phi!r}")

    out = torch.empty((bh, g, dv), dtype=q.dtype, device=q.device)
    fn = _lib.function("flow_decode_q", "flow_decode_q_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(t.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             *(x.data_ptr() for x in pays + scales), z.data_ptr(),
             out.data_ptr(), bh, hkv, g, d, dv, DTYPE_CODES[q.dtype],
             PHI_CODES[phi], int(use_alloc), eps, stream)
    _lib.check(fn, err, "flow_decode_q")
    LAUNCHES["flow_decode_q"] += 1
    return out
