"""Causal-dot primitives with internal path selection.

The counterpart of ``repro/attention/dots.py``.  ``out_i = q_i .
sum_{j<=i} k_j^T v_j`` is the aggregation shared by flow and plain linear
attention; these helpers choose between its cumsum, chunked-scan and
kernel realizations.  Where the reference runs its Pallas kernel on a
TPU, the port runs the CUDA kernel K5a on a CUDA tensor: there it
launches the kernel or raises, and never falls back to a plain version.
"""
from __future__ import annotations

import torch

from repro_torch.attention.chunked import (chunked_causal_dot,
                                           chunked_causal_dot_grouped)


def causal_dot(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               chunk_size: int = 128) -> torch.Tensor:
    """Ungrouped causal dot.  q, k: (..., N, D); v: (..., N, Dv).

    The chunked scan when N divides by ``chunk_size``; otherwise a cumsum
    (O(N D Dv) memory -- test scale only).
    """
    n = q.shape[-2]
    if chunk_size and n % chunk_size == 0 and n > chunk_size:
        return chunked_causal_dot(q, k, v, chunk_size)
    kv = torch.cumsum(torch.einsum("...nd,...ne->...nde", k, v), dim=-3)
    return torch.einsum("...nd,...nde->...ne", q, kv)


def causal_dot_grouped(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       chunk_size: int = 128, *,
                       use_kernel: bool | None = None) -> torch.Tensor:
    """Grouped causal dot sharing the carried state across the GQA group.

    qg: (B, Hkv, G, N, D); k: (B, Hkv, N, D); v: (B, Hkv, N, Dv) ->
    (B, Hkv, G, N, Dv).  ``use_kernel=None`` means "on a CUDA tensor":
    K5a through ``FlowChunkDot`` (differentiable), padded to
    ``chunk_size`` or, where it is <= 0, to K5a's own chunk
    (``_lib.kernel_chunk``); False keeps to the plain versions on any
    device, a cumsum at ``chunk_size <= 0``.
    """
    if use_kernel is None:
        use_kernel = qg.is_cuda
    if use_kernel:
        from repro_torch.attention._cuda import chunked_causal_dot_cuda

        return chunked_causal_dot_cuda(qg, k, v, chunk=chunk_size)
    n = qg.shape[-2]
    if chunk_size and n % chunk_size == 0 and n > chunk_size:
        return chunked_causal_dot_grouped(qg, k, v, chunk_size)
    kv = torch.cumsum(torch.einsum("bhnd,bhne->bhnde", k, v), dim=2)
    return torch.einsum("bhgnd,bhnde->bhgne", qg, kv)
