"""Glue from the pipeline's (B, H, ...) layout to the flow_chunk kernels.

The counterpart of ``repro/attention/_pallas.py``: N is zero-padded to a
multiple of the chunk (``_lib.kernel_chunk``) -- zero k/v rows add
nothing to the carried state, so nothing is masked -- the heads are
flattened into the kernels' (BH, ...) rows, and the pad is sliced off the
result.  A head width of ``_lib.PADDED_HEAD_DIMS`` (D or Dv = 24) is
zero-padded to its stored width (32, ``_lib.pad_lanes``) the same way:
the operands are the dot's, phi already applied, so zero lanes add
nothing either.  The call goes through ``attention/vjp.py::FlowChunkDot``,
so autograd runs K5a for dq and K5b for dk and dv.
"""
from __future__ import annotations

import torch

from repro_torch.attention.fused import pad_seq, padded_len
from repro_torch.kernels._lib import kernel_chunk, pad_lanes


def chunked_causal_dot_cuda(qg: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *,
                            chunk: int = 128) -> torch.Tensor:
    """qg: (B, H, G, N, D); k: (B, H, N, D); v: (B, H, N, Dv) ->
    (B, H, G, N, Dv) through K5a (forward) and K5a + K5b (backward)."""
    from repro_torch.attention.vjp import FlowChunkDot  # lazy: cycle

    b, h, g, n, d = qg.shape
    dv = v.shape[-1]
    n_pad = padded_len(n, kernel_chunk(n, chunk, d, dv))
    out = FlowChunkDot.apply(
        pad_seq(pad_lanes(qg.reshape(b * h, g, n, d)), n_pad, 2).contiguous(),
        pad_seq(pad_lanes(k.reshape(b * h, n, d)), n_pad, 1).contiguous(),
        pad_seq(pad_lanes(v.reshape(b * h, n, dv)), n_pad, 1).contiguous())
    return out[:, :, :n, :dv].reshape(b, h, g, n, dv)
