"""Plain PyTorch versions of the gathers: K9 and K8a, K8b.

``boundary_gather_ref`` is the off-TPU branch of ``repro/kernels/gather/
boundary.py::boundary_gather`` (:52-58): zero-pad the whole (B, N, W)
stream on the left by k - 1 rows and gather rows ``lengths[b] + j``,
j < k - 1, of the padded stream.  ``boundary_gather_many_ref`` does so
for each of several streams that share the lengths.

``paged_gather_ref`` and ``paged_gather_quant_ref`` are the off-TPU
branches of ``repro/kernels/gather/paged.py::paged_gather`` (:42-48) and
``paged_gather_quant`` (:105-111): index the pool by the page table with
its ids clamped into [0, P - 1], then lay the pages out head-major as one
(B, Hkv, MP * page, D) sequence per slot; the quantized one multiplies
the int8 payload by its per-token fp32 scale and rounds once to
``out_dtype``.
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


def boundary_gather_many_ref(streams, lengths: torch.Tensor,
                             k: int) -> tuple:
    """``boundary_gather_ref`` of each (B, N, W_i) stream, as a tuple."""
    return tuple(boundary_gather_ref(x, lengths, k) for x in streams)


def _head_major(g: torch.Tensor) -> torch.Tensor:
    """(B, MP, Hkv, page, D) gathered pages -> (B, Hkv, MP * page, D)."""
    b, mp, hkv, page, d = g.shape
    return g.transpose(1, 2).reshape(b, hkv, mp * page, d)


def paged_gather_ref(kc: torch.Tensor, vc: torch.Tensor,
                     table: torch.Tensor):
    """kc, vc: (P, Hkv, page, D | Dv) pools; table: (B, MP) int page ids.
    Returns (kg, vg), (B, Hkv, MP * page, D | Dv) in the pools' dtype."""
    idx = table.to(device=kc.device, dtype=torch.long).clamp(0, kc.shape[0] - 1)
    return _head_major(kc[idx]), _head_major(vc[idx])


def paged_gather_quant_ref(kc: torch.Tensor, vc: torch.Tensor,
                           ks: torch.Tensor, vs: torch.Tensor,
                           table: torch.Tensor, *, out_dtype):
    """``paged_gather_ref`` on int8 payload pools with fp32 per-token
    scales ks, vs (P, Hkv, page, 1): out = f32(payload) * scale, rounded
    once to ``out_dtype``."""
    idx = table.to(device=kc.device, dtype=torch.long).clamp(0, kc.shape[0] - 1)

    def flat(pool, spool):
        return _head_major(pool[idx].float() * spool[idx]).to(out_dtype)

    return flat(kc, ks), flat(vc, vs)
