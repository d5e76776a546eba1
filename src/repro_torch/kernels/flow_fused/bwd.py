"""Wrapper of the flow_fused backward CUDA kernel (``csrc/flow_fused_bwd.cu``).

``flow_fused_bwd_call`` is K2, the counterpart of
``repro/kernels/flow_fused/bwd.py::flow_fused_bwd_call``: the gradients of
``flow_fused_call`` w.r.t. (q, k, v), from the forward's six state totals
and the cotangents of ``out`` and of the six state outputs.  CPU tensors
run the plain version (``ref.py::flow_fused_bwd_ref``, autograd through
K1's plain version), uncounted; CUDA tensors launch the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._lib import DTYPE_CODES, LAUNCHES, PHI_CODES
from repro_torch.kernels.flow_fused.ops import check_flat, workspace
from repro_torch.kernels.flow_fused.ref import flow_fused_bwd_ref

__all__ = ["flow_fused_bwd_call"]

_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                           ctypes.c_void_p]


def _check_state(name: str, xs, shapes, device):
    for i, (x, shape) in enumerate(zip(xs, shapes)):
        if (x.device != device or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"{name}[{i}] must be contiguous fp32 of shape "
                             f"{shape} on {device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def flow_fused_bwd_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lens: torch.Tensor, totals, g_out: torch.Tensor,
                        g_sums, *, chunk: int = 128, eps: float = 1e-6,
                        phi: str = "sigmoid", use_alloc: bool = True):
    """Gradients of ``flow_fused_call`` w.r.t. (q, k, v).

    q/k/v/lens as ``flow_fused_call`` takes them; ``totals`` are the six
    state outputs it returned and ``g_sums`` their cotangents, each
    (q/k/ko/qi sums (BH, D), z (BH,), s (BH, D, Dv)) fp32; ``g_out``
    (BH, G, N, Dv) in the primal dtype.  The kernel reads none of the
    totals (they are checked only): it recomputes the flows and the chunk
    states itself.  Its scratch is one ``workspace`` per call: the
    per-position flows, each super-chunk's carry-in of the five small sums
    (4 D + 1 floats), the chunk states and their cotangents (D x Dv per
    chunk each) and the chunk stage's d q_in, d phi(k) and per-position
    scalars for the flows' pull-back.  One call is one count in
    ``LAUNCHES`` and five CUDA kernels.  Returns (dq, dk, dv) in the
    primal dtypes; positions past ``lens`` get zeros.
    """
    if q.shape[2] % chunk:
        raise ValueError(f"N={q.shape[2]} is not a multiple of chunk={chunk}")
    if q.device.type == "cpu":
        return flow_fused_bwd_ref(q, k, v, lens, g_out, g_sums, chunk=chunk,
                                  eps=eps, phi=phi, use_alloc=use_alloc)
    bh, g, n, d = check_flat(q, k, v, lens, phi)
    if (g_out.device != q.device or g_out.dtype != q.dtype
            or g_out.shape != q.shape or not g_out.is_contiguous()):
        raise ValueError(f"g_out must be contiguous {q.dtype} of shape "
                         f"{tuple(q.shape)} on {q.device}")
    shapes = [(bh, d)] * 4 + [(bh,), (bh, d, d)]
    _check_state("totals", totals, shapes, q.device)
    _check_state("g_sums", g_sums, shapes, q.device)

    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    work = workspace("flow_fused_bwd", q, bh, g, n, d)
    fn = _lib.function("flow_fused_bwd", "flow_fused_bwd", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
             g_out.data_ptr(), *(x.data_ptr() for x in g_sums), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), work.data_ptr(), bh, g, n, d, d,
             DTYPE_CODES[q.dtype], PHI_CODES[phi], int(use_alloc), eps, stream)
    _lib.check(fn, err, "flow_fused_bwd")
    LAUNCHES["flow_fused_bwd"] += 1
    return dq, dk, dv
