"""Plain PyTorch version of K9, the boundary-history gather.

The counterpart of the off-TPU branch of ``repro/kernels/gather/
boundary.py::boundary_gather`` (:52-58): zero-pad the whole (B, N, W)
stream on the left by k - 1 rows and gather rows ``lengths[b] + j``,
j < k - 1, of the padded stream.
"""
from __future__ import annotations

import torch


def boundary_gather_ref(xb: torch.Tensor, lengths: torch.Tensor,
                        k: int) -> torch.Tensor:
    """xb: (B, N, W); lengths: (B,) int in [0, N].  Returns (B, k-1, W):
    row b's last k - 1 inputs before position ``lengths[b]``, zero-filled
    on the left like a fresh causal-conv pad."""
    bsz, _, w = xb.shape
    pad = torch.zeros((bsz, k - 1, w), dtype=xb.dtype, device=xb.device)
    xp = torch.cat([pad, xb], dim=1)
    idx = (lengths.to(device=xb.device, dtype=torch.long)[:, None]
           + torch.arange(k - 1, device=xb.device)[None, :])
    return torch.take_along_dim(xp, idx[..., None], dim=1)
