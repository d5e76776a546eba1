"""Rotary position embeddings (RoPE): split halves rotated in fp32."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10_000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def _rotate(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, H, N, D); positions: (B, N) int."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (D/2,)
    angles = positions[:, None, :, None].float() * freqs  # (B,1,N,D/2)
    return _rotate(x.float(), torch.cos(angles), torch.sin(angles)).to(x.dtype)


def default_positions(batch: int, n: int, offset=0, *, device=None):
    """(B, N) int32 positions ``offset + arange(n)``; ``offset`` may be a
    (B,) tensor of per-slot offsets (continuous batching)."""
    pos = torch.arange(n, dtype=torch.int32, device=device)[None, :]
    if isinstance(offset, torch.Tensor):
        off = offset.to(device=device, dtype=torch.int32)
        if off.ndim == 1:
            off = off[:, None]
        return pos + off + torch.zeros((batch, 1), dtype=torch.int32,
                                       device=device)
    return (pos + int(offset)).expand(batch, n).contiguous()
