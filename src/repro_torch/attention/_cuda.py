"""Glue from the pipeline's (B, H, ...) layout to the flow_chunk kernels.

The counterpart of ``repro/attention/_pallas.py``: N is zero-padded to a
multiple of ``effective_chunk(n, chunk)`` -- zero k/v rows add nothing to
the carried state, so nothing is masked -- the heads are flattened into
the kernels' (BH, ...) rows, and the pad is sliced off the result.  The
call goes through ``attention/vjp.py::FlowChunkDot``, so autograd runs
K5a for dq and K5b for dk and dv.
"""
from __future__ import annotations

import torch

from repro_torch.attention.fused import effective_chunk, pad_seq, padded_len


def chunked_causal_dot_cuda(qg: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *,
                            chunk: int = 128) -> torch.Tensor:
    """qg: (B, H, G, N, D); k: (B, H, N, D); v: (B, H, N, Dv) ->
    (B, H, G, N, Dv) through K5a (forward) and K5a + K5b (backward)."""
    from repro_torch.attention.vjp import FlowChunkDot  # lazy: cycle

    b, h, g, n, d = qg.shape
    dv = v.shape[-1]
    n_pad = padded_len(n, effective_chunk(n, chunk))
    out = FlowChunkDot.apply(
        pad_seq(qg.reshape(b * h, g, n, d), n_pad, 2).contiguous(),
        pad_seq(k.reshape(b * h, n, d), n_pad, 1).contiguous(),
        pad_seq(v.reshape(b * h, n, dv), n_pad, 1).contiguous())
    return out[:, :, :n].reshape(b, h, g, n, dv)
