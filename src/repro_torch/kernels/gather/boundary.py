"""Wrapper of the boundary-gather CUDA kernel (``csrc/boundary_gather.cu``,
K9).

``boundary_gather(xb, lengths, k)`` returns each row's last k - 1 inputs
before its own boundary ``lengths[b]`` -- the decode conv history that
packed prefill hands to each slot.  ``interpret`` follows the reference's
switch: None (the default) launches the kernel on a CUDA tensor and runs
the plain version (``ref.py``) on a CPU one; True runs the plain version
on any device, uncounted (for tests and the card's plain-path checks).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._lib import LAUNCHES
from repro_torch.kernels.gather.ref import boundary_gather_ref

__all__ = ["LAUNCHES", "boundary_gather"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ELEM_SIZES = {torch.float32: 4, torch.bfloat16: 2}


def _check(xb: torch.Tensor, lengths: torch.Tensor, k: int):
    if xb.device.type != "cuda":
        raise ValueError(f"boundary_gather runs on cuda or cpu, not "
                         f"{xb.device}")
    if lengths.device != xb.device:
        raise ValueError(f"lengths is on {lengths.device}, xb on {xb.device}")
    if xb.dtype not in _ELEM_SIZES:
        raise ValueError(f"kernel takes fp32 or bf16, got {xb.dtype}")
    if xb.ndim != 3 or not xb.is_contiguous():
        raise ValueError(f"xb must be a contiguous (B, N, W) tensor, got "
                         f"shape {tuple(xb.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != xb.shape[:1]:
        raise ValueError(f"lengths must be int32 of shape ({xb.shape[0]},)")
    if k < 1 or xb.shape[1] < 1:
        raise ValueError(f"need k >= 1 and N >= 1, got k={k}, N="
                         f"{xb.shape[1]}")


def boundary_gather(xb: torch.Tensor, lengths: torch.Tensor, k: int, *,
                    interpret: bool | None = None) -> torch.Tensor:
    """xb: (B, N, W); lengths: (B,) int in [0, N].  Returns (B, k-1, W)
    in xb's dtype: row b's inputs at positions lengths[b] - k + 1 ..
    lengths[b] - 1, zeros where a position is below 0."""
    if interpret or xb.device.type == "cpu":
        return boundary_gather_ref(xb, lengths, k)
    lengths = lengths.to(torch.int32)
    _check(xb, lengths, k)
    bsz, n, w = xb.shape
    out = torch.empty((bsz, k - 1, w), dtype=xb.dtype, device=xb.device)
    if out.numel() == 0:
        return out
    fn = _lib.function("boundary_gather", "boundary_gather", _ARGTYPES)
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = fn(xb.data_ptr(), lengths.data_ptr(), out.data_ptr(), bsz, n, w,
             k, _ELEM_SIZES[xb.dtype], stream)
    _lib.check(fn, err, "boundary_gather")
    LAUNCHES["boundary_gather"] += 1
    return out
