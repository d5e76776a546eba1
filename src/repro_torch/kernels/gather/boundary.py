"""Wrapper of the boundary-gather CUDA kernel (``csrc/boundary_gather.cu``,
K9).

``boundary_gather_many(streams, lengths, k)`` returns, for each of 1 to 4
(B, N, W_i) streams, each row's last k - 1 inputs before its own boundary
``lengths[b]`` -- the decode conv histories that packed prefill hands to
each slot -- from one launch: the mamba2 layer gathers its x, B and C
streams together.  ``boundary_gather(xb, lengths, k)`` is its one-stream
case.  ``interpret`` follows the reference's switch: None (the default)
launches the kernel on CUDA tensors and runs the plain version
(``ref.py``) on CPU ones; True runs the plain version on any device,
uncounted (for tests and the card's plain-path checks).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._lib import LAUNCHES
from repro_torch.kernels.gather.ref import (boundary_gather_many_ref,
                                            boundary_gather_ref)

__all__ = ["LAUNCHES", "boundary_gather", "boundary_gather_many"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _P] + [_I] * 4 + [_P]
_ELEM_SIZES = {torch.float32: 4, torch.bfloat16: 2}
#: streams one launch gathers (``kMaxStreams`` in the source)
MAX_STREAMS = 4


def _check_streams(streams, lengths: torch.Tensor, k: int):
    """Raise unless ``streams`` is 1 to ``MAX_STREAMS`` (B, N, W_i) tensors
    of one dtype with the first one's B and N, naming the stream at fault
    by its index; on every device, before any launch."""
    if not 1 <= len(streams) <= MAX_STREAMS:
        raise ValueError(f"boundary_gather_many takes 1 to {MAX_STREAMS} "
                         f"streams, got {len(streams)}")
    first = streams[0]
    for i, x in enumerate(streams):
        if x.ndim != 3:
            raise ValueError(f"stream {i} must be (B, N, W), got shape "
                             f"{tuple(x.shape)}")
        if x.shape[:2] != first.shape[:2]:
            raise ValueError(f"stream {i} has (B, N) = {tuple(x.shape[:2])}"
                             f", stream 0 {tuple(first.shape[:2])}")
        if x.dtype != first.dtype:
            raise ValueError(f"stream {i} is {x.dtype}, stream 0 "
                             f"{first.dtype}")
        if x.device != first.device:
            raise ValueError(f"stream {i} is on {x.device}, stream 0 on "
                             f"{first.device}")
    if k < 1 or first.shape[1] < 1:
        raise ValueError(f"need k >= 1 and N >= 1, got k={k}, N="
                         f"{first.shape[1]}")
    if lengths.shape != first.shape[:1]:
        raise ValueError(f"lengths must have shape ({first.shape[0]},), got "
                         f"{tuple(lengths.shape)}")


def _check_kernel(streams, lengths: torch.Tensor):
    """What the kernel takes beyond ``_check_streams``."""
    first = streams[0]
    if first.device.type != "cuda":
        raise ValueError(f"boundary_gather runs on cuda or cpu, not "
                         f"{first.device}")
    if lengths.device != first.device or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 on {first.device}, got "
                         f"{lengths.dtype} on {lengths.device}")
    if first.dtype not in _ELEM_SIZES:
        raise ValueError(f"kernel takes fp32 or bf16, got {first.dtype}")
    for i, x in enumerate(streams):
        if not x.is_contiguous():
            raise ValueError(f"stream {i} must be contiguous")


def boundary_gather_many(streams, lengths: torch.Tensor, k: int, *,
                         interpret: bool | None = None) -> tuple:
    """streams: 1 to 4 (B, N, W_i) tensors of one dtype; lengths: (B,) int
    in [0, N].  Returns a tuple of (B, k-1, W_i) tensors: for each stream,
    row b's inputs at positions lengths[b] - k + 1 .. lengths[b] - 1,
    zeros where a position is below 0.  One launch on CUDA."""
    streams = tuple(streams)
    _check_streams(streams, lengths, k)
    first = streams[0]
    if interpret or first.device.type == "cpu":
        return boundary_gather_many_ref(streams, lengths, k)
    lengths = lengths.to(torch.int32)
    _check_kernel(streams, lengths)
    bsz, n = first.shape[:2]
    outs = tuple(torch.empty((bsz, k - 1, x.shape[2]), dtype=x.dtype,
                             device=x.device) for x in streams)
    if sum(o.numel() for o in outs) == 0:
        return outs
    count = len(streams)
    ptrs = lambda ts: (ctypes.c_void_p * count)(  # noqa: E731
        *(t.data_ptr() for t in ts))
    widths = (ctypes.c_int * count)(*(x.shape[2] for x in streams))
    fn = _lib.function("boundary_gather", "boundary_gather_many", _ARGTYPES)
    stream = torch.cuda.current_stream(first.device).cuda_stream
    err = fn(ptrs(streams), ptrs(outs), widths, count, lengths.data_ptr(),
             bsz, n, k, _ELEM_SIZES[first.dtype], stream)
    _lib.check(fn, err, "boundary_gather")
    LAUNCHES["boundary_gather"] += 1
    return outs


def boundary_gather(xb: torch.Tensor, lengths: torch.Tensor, k: int, *,
                    interpret: bool | None = None) -> torch.Tensor:
    """xb: (B, N, W); lengths: (B,) int in [0, N].  Returns (B, k-1, W)
    in xb's dtype: ``boundary_gather_many``'s one-stream case."""
    if interpret:
        return boundary_gather_ref(xb, lengths, k)
    return boundary_gather_many((xb,), lengths, k)[0]
