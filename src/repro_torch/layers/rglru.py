"""The causal-conv helpers of the recurrent mixers.

The counterpart of the two helpers ``repro/layers/ssd.py`` imports from
``repro/layers/rglru.py`` (:72-84 and :122-135): the depthwise causal
conv along time with a decode history, and the per-row conv history at
each row's boundary for packed prefill.  The RG-LRU mixer itself is not
ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gather import boundary_gather


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: torch.Tensor | None = None):
    """Depthwise causal conv along time.  x: (B, N, W); w: (K, W); b: (W,);
    history: the (B, K-1, W) inputs before x, zeros when None.  Returns
    (y (B, N, W), the last K-1 inputs).  A sum of K shifted products in
    x's dtype, as the reference writes it (no cuDNN conv, which would run
    fp32 in TF32)."""
    k, n = w.shape[0], x.shape[1]
    if history is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = history.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, N+K-1, W)
    y = sum(xp[:, i:i + n] * w[i].to(x.dtype) for i in range(k))
    return y + b.to(x.dtype), xp[:, xp.shape[1] - (k - 1):]


def _boundary_conv_history(xb: torch.Tensor, lengths: torch.Tensor,
                           k: int) -> torch.Tensor:
    """Per-row trailing conv inputs at each row's boundary: row i's last
    k-1 inputs before position ``lengths[i]``, zero-filled on the left for
    rows shorter than the window (a fresh ``_causal_conv`` pad).  On a
    GPU the K9 kernel reads the raw stream once; on the CPU the plain pad
    and gather."""
    return boundary_gather(xb, lengths, k)
