"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE, split
halves rotated in fp32.

M-RoPE (arXiv:2409.12191) splits the head dim's frequency bands into
(temporal, height, width) sections and rotates each with its own position
stream; text tokens carry identical (t, h, w) positions and reduce to
RoPE.
"""
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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, ...], *,
                theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, H, N, D); positions: (B, 3, N) int, the (t, h, w) streams.

    ``sections`` gives the number of frequency pairs of each stream and
    must sum to D / 2 (e.g. (16, 24, 24) for D = 128): frequency band j
    turns with the position of the stream whose section holds j."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"D / 2 = {d // 2}")
    freqs = rope_freqs(d, theta, device=x.device)  # (D/2,)
    stream = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device))  # (D/2,) stream per band
    pos = positions.float()[:, stream]  # (B, D/2, N)
    angles = pos.transpose(1, 2)[:, None] * freqs  # (B,1,N,D/2)
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


def default_mrope_positions(batch: int, n: int, offset=0, *, device=None):
    """(B, 3, N) int32: ``default_positions`` on each of the (t, h, w)
    streams (text tokens)."""
    p = default_positions(batch, n, offset, device=device)
    return p[:, None, :].expand(batch, 3, n).contiguous()
