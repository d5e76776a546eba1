"""Error-feedback int8 gradient compression for the data-parallel
all-reduce, the counterpart of ``repro/training/compression.py``.

Each step the gradient plus the carried residual is quantized to int8
with one scale a leaf shared by every position (the ``pmax`` of their
maxima over 127), the int8 payloads are summed in int32 (4x fewer bytes
on the wire than fp32), the sum is dequantized into the mean, and each
position keeps its quantization residual for the next step (error
feedback; Karimireddy et al. 2019).

The reference runs ``compressed_psum`` inside ``shard_map`` over the dp
axis.  On the port's single controller it takes one gradient tree and one
residual tree a data-parallel position (lists in rank order) and runs the
collectives of ``distribution/collectives.py``: the shared scale is a
``pmax``, the payloads an int32 ``psum`` in rank order, so the result is
bitwise repeatable.  The division ``g / scale`` is the true division and
``torch.round`` rounds half to even, as ``jnp.round`` does, so the
payloads equal the reference's bit for bit; the residual ``g - q *
scale`` is rounded once, as XLA's fused multiply-add rounds it.
"""
from __future__ import annotations

import torch

from repro_torch.distribution.collectives import pmax, psum
from repro_torch.utils import tree_leaves, tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, fp32 scale): the scale is max|x| (at least 1e-12)
    over 127."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_payloads(gs: list, rs: list, mesh, axis) -> tuple[list, list, list]:
    """One leaf's error-feedback quantization at every position: (the
    int8 payloads, the shared scale as each position holds it, the new
    residuals)."""
    gs = [g.float() + r for g, r in zip(gs, rs)]
    # a SHARED scale: summing the int8 payloads and multiplying by one
    # scale is exact up to the rounding that error feedback carries;
    # per-position scales would bias the mean
    peaks = pmax([torch.clamp(g.abs().max(), min=1e-12) for g in gs],
                 mesh, axis, over=axis)
    scales = [p / 127.0 for p in peaks]
    qs = [torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
          for g, s in zip(gs, scales)]
    # error feedback, g - q * scale rounded once (as a fused multiply-add
    # rounds it): q * scale is exact in fp64
    new_r = [(g.double() - q.double() * s.double()).float()
             for g, q, s in zip(gs, qs, scales)]
    return qs, scales, new_r


def compressed_psum(grads: list, residual: list, mesh, axis="data"
                    ) -> tuple[list, list]:
    """The int8 error-feedback all-reduce over ``axis`` (a dp axis name or
    tuple) of ``mesh``: ``grads`` and ``residual`` hold one tree a
    position of that axis, in rank order.  Returns (each position's tree
    of mean-reduced fp32 grads, each position's new residual tree)."""
    n = len(grads)
    flat_g = [tree_leaves(g) for g in grads]
    flat_r = [tree_leaves(r) for r in residual]
    means = [[] for _ in range(n)]
    resid = [[] for _ in range(n)]
    for j in range(len(flat_g[0])):
        qs, scales, new_r = ef_payloads([f[j] for f in flat_g],
                                        [f[j] for f in flat_r], mesh, axis)
        # the int8 payloads all-reduce as int32 accumulators: no overflow
        summed = psum([q.to(torch.int32) for q in qs], mesh, axis, over=axis)
        for i in range(n):
            means[i].append(summed[i].float() * scales[i] / n)
            resid[i].append(new_r[i])
    return ([_like(grads[i], means[i]) for i in range(n)],
            [_like(grads[i], resid[i]) for i in range(n)])


def _like(tree, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_compressed_allreduce(mesh, dp_axis="data"):
    """``(grads, residual) -> (mean_grads, residual)`` over ``mesh``'s
    ``dp_axis``, each a list of trees, one a position."""
    def fn(grads, residual):
        return compressed_psum(grads, residual, mesh, dp_axis)

    return fn
