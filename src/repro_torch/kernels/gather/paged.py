"""Wrappers of the page-table gather CUDA kernels (``csrc/paged_gather.cu``,
K8a and K8b).

``paged_gather(kc, vc, table)`` lays the pool pages each slot's table row
names out as one head-major (B, Hkv, MP * page, D) sequence per slot, in
the pool's dtype; ``paged_gather_quant`` does the same from int8 payload
pools and dequantizes inline with the per-token fp32 scales, rounding
once to ``out_dtype``.  Table ids outside [0, P - 1] (the sentinel of an
unmapped page) clamp into the pool, as the reference's do; the caller
masks those positions by ``kv_len``.  ``interpret`` follows the
reference's switch: None (the default) launches the kernel on a CUDA
tensor and runs the plain version (``ref.py``) on a CPU one; True runs the
plain version on any device, uncounted (for tests and the card's
plain-path checks).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._lib import LAUNCHES
from repro_torch.kernels.gather.ref import (paged_gather_quant_ref,
                                            paged_gather_ref)

__all__ = ["LAUNCHES", "paged_gather", "paged_gather_quant"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 8 + [_P]
_ARGTYPES_QUANT = [_P] * 7 + [_I] * 8 + [_P]
_ELEM_SIZES = {torch.float32: 4, torch.bfloat16: 2}


def _check_pools(what: str, kc, vc, table, payload_dtypes):
    if kc.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {kc.device}")
    for name, x in (("vc", vc), ("table", table)):
        if x.device != kc.device:
            raise ValueError(f"{name} is on {x.device}, kc on {kc.device}")
    if kc.dtype not in payload_dtypes or vc.dtype != kc.dtype:
        raise ValueError(f"{what} takes kc and vc of one dtype among "
                         f"{payload_dtypes}, got {kc.dtype} and {vc.dtype}")
    if kc.ndim != 4 or vc.ndim != 4 or kc.shape[:3] != vc.shape[:3]:
        raise ValueError(f"kc and vc must be (P, Hkv, page, D | Dv) pools of "
                         f"one geometry, got {tuple(kc.shape)} and "
                         f"{tuple(vc.shape)}")
    if not (kc.is_contiguous() and vc.is_contiguous()):
        raise ValueError("kc and vc must be contiguous")
    if table.ndim != 2 or table.dtype != torch.int32 \
            or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous (B, MP) int32 tensor, "
                         f"got {table.dtype} of shape {tuple(table.shape)}")
    if kc.shape[0] < 1:
        raise ValueError("the pool has no page")


def _out(kc, vc, table, dtype):
    _, hkv, page, d = kc.shape
    b, mp = table.shape
    return (torch.empty((b, hkv, mp * page, d), dtype=dtype, device=kc.device),
            torch.empty((b, hkv, mp * page, vc.shape[-1]), dtype=dtype,
                        device=kc.device))


def _dims(kc, vc, table):
    p, hkv, page, d = kc.shape
    b, mp = table.shape
    return p, hkv, page, d, vc.shape[-1], b, mp


def paged_gather(kc: torch.Tensor, vc: torch.Tensor, table: torch.Tensor, *,
                 interpret: bool | None = None):
    """kc, vc: (P, Hkv, page, D | Dv) bf16 or fp32 pools; table: (B, MP)
    int page ids.  Returns (kg, vg), (B, Hkv, MP * page, D | Dv)."""
    if interpret or kc.device.type == "cpu":
        return paged_gather_ref(kc, vc, table)
    table = table.to(torch.int32)
    _check_pools("paged_gather", kc, vc, table, tuple(_ELEM_SIZES))
    kg, vg = _out(kc, vc, table, kc.dtype)
    if kg.numel() == 0 and vg.numel() == 0:
        return kg, vg
    fn = _lib.function("paged_gather", "paged_gather", _ARGTYPES)
    stream = torch.cuda.current_stream(kc.device).cuda_stream
    err = fn(kc.data_ptr(), vc.data_ptr(), table.data_ptr(), kg.data_ptr(),
             vg.data_ptr(), *_dims(kc, vc, table), _ELEM_SIZES[kc.dtype],
             stream)
    _lib.check(fn, err, "paged_gather")
    LAUNCHES["paged_gather"] += 1
    return kg, vg


def paged_gather_quant(kc: torch.Tensor, vc: torch.Tensor, ks: torch.Tensor,
                       vs: torch.Tensor, table: torch.Tensor, *, out_dtype,
                       interpret: bool | None = None):
    """kc, vc: (P, Hkv, page, D | Dv) int8 payload pools; ks, vs:
    (P, Hkv, page, 1) fp32 per-token scales; table: (B, MP) int page ids.
    Returns (kg, vg), (B, Hkv, MP * page, D | Dv) in ``out_dtype`` (bf16
    or fp32): f32(payload) * scale, rounded once."""
    if interpret or kc.device.type == "cpu":
        return paged_gather_quant_ref(kc, vc, ks, vs, table,
                                      out_dtype=out_dtype)
    table = table.to(torch.int32)
    _check_pools("paged_gather_quant", kc, vc, table, (torch.int8,))
    for name, s in (("ks", ks), ("vs", vs)):
        if s.device != kc.device or s.dtype != torch.float32 \
                or s.shape != kc.shape[:3] + (1,) or not s.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 "
                             f"{tuple(kc.shape[:3]) + (1,)} tensor on "
                             f"{kc.device}, got {s.dtype} of shape "
                             f"{tuple(s.shape)} on {s.device}")
    if out_dtype not in _ELEM_SIZES:
        raise ValueError(f"out_dtype must be bf16 or fp32, got {out_dtype}")
    kg, vg = _out(kc, vc, table, out_dtype)
    if kg.numel() == 0 and vg.numel() == 0:
        return kg, vg
    fn = _lib.function("paged_gather", "paged_gather_quant", _ARGTYPES_QUANT)
    stream = torch.cuda.current_stream(kc.device).cuda_stream
    err = fn(kc.data_ptr(), vc.data_ptr(), ks.data_ptr(), vs.data_ptr(),
             table.data_ptr(), kg.data_ptr(), vg.data_ptr(),
             *_dims(kc, vc, table), int(out_dtype == torch.bfloat16), stream)
    _lib.check(fn, err, "paged_gather_quant")
    LAUNCHES["paged_gather_quant"] += 1
    return kg, vg
