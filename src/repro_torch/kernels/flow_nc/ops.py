"""Wrappers of the flow_nc CUDA kernels: K6 (``csrc/flow_nc_fused.cu``),
K7a and K7b (``csrc/flow_nc_qside.cu``).

* ``flow_nc_fused_call`` (K6): the whole non-causal pair in one launch;
* ``flow_nc_qside_call`` (K7a): the sink side from the key-side reductions;
* ``flow_nc_qside_bwd_call`` (K7b): K7a's cotangents;
* ``flow_attention_nc``: (B, Hq, N, D) inputs grouped into the kernels'
  flat (B*Hkv, G*N, D) layout -- the G query heads of a kv head form one
  sink population -- and through ``attention/vjp.py::FlowNCFused`` (K6
  forward; backward through K7b), as
  ``repro/kernels/flow_nc/ops.py::flow_attention_nc_pallas`` does around
  the TPU kernels.

CPU tensors run the plain versions (``ref.py``), uncounted; CUDA tensors
launch the kernel or raise.  The kernels' outputs record no autograd
history, so on CUDA K6 and K7a refuse inputs that autograd would
differentiate outside ``FlowNCFused`` / ``FlowNCQside``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.flow_attention import FlowConfig, _group
from repro_torch.kernels import _lib
from repro_torch.kernels._lib import (DTYPE_CODES, LAUNCHES, NC_HEAD_DIMS,
                                     NC_SMALL_THREADS)
from repro_torch.kernels.flow_nc.ref import (flow_nc_fused_ref,
                                             flow_nc_qside_bwd_ref,
                                             flow_nc_qside_ref)

__all__ = ["LAUNCHES", "cluster_blocks", "flow_attention_nc",
           "flow_nc_fused_call", "flow_nc_qside_bwd_call",
           "flow_nc_qside_call"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FUSED_ARGTYPES = [_P] * 4 + [_I] * 8 + [_F, _P]
_QSIDE_ARGTYPES = [_P] * 5 + [_I] * 5 + [_F, _F, _P]
_QSIDE_BWD_ARGTYPES = [_P] * 10 + [_I] * 6 + [_F, _F, _P]

#: blocks of K6's thread-block cluster per (batch * kv head): 16, the
#: card's non-portable cluster size (the kernel opts in), at which the LRA
#: shape's rows fit two blocks to an SM; 8 is the portable size
CLUSTER_BLOCKS = 16


def cluster_blocks(nq: int, m: int, d: int) -> int:
    """Blocks of K6's cluster per (batch * kv head) at NQ sinks, M sources
    and head dim D: ``CLUSTER_BLOCKS`` on the tensor-core route; on the
    small-head route as many as a block's one row a thread needs for the
    longer side, at most ``CLUSTER_BLOCKS`` (the vision encoder's stages:
    13, 4, 1 and 1 blocks), so that short rows take no cluster barriers
    and no DSMEM exchange of a kv that every block would sum again."""
    if d not in NC_SMALL_THREADS:
        return CLUSTER_BLOCKS
    return max(1, min(CLUSTER_BLOCKS, -(-max(nq, m) // NC_SMALL_THREADS[d])))


def _check(device, **xs):
    """Raise unless every tensor is on ``device``, contiguous and 16-byte
    aligned at its base (the kernels load 16 bytes at a time at D = 32, 64
    and 128; at the small head dims a row is read in element pairs, so a
    row of any whole number of pairs is read where it lies)."""
    for name, x in xs.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_rows(q: torch.Tensor, *others: torch.Tensor):
    """q (BH, N, D) on CUDA in fp32 or bf16, D in ``NC_HEAD_DIMS``;
    ``others`` in q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"flow_nc runs on cuda or cpu, not {q.device}")
    if q.dtype not in DTYPE_CODES or any(x.dtype != q.dtype for x in others):
        raise ValueError("q, k, v and g must share fp32 or bf16, got "
                         + "/".join(str(x.dtype) for x in (q, *others)))
    if q.ndim != 3 or q.shape[1] < 1 or q.shape[2] not in NC_HEAD_DIMS:
        raise ValueError(f"q must be (BH, N >= 1, D) with D in "
                         f"{NC_HEAD_DIMS}, got {tuple(q.shape)}")


def _check_key_side(q, k_sum, ko_sum, kv):
    bh, _, d = q.shape
    for name, x, shape in (("k_sum", k_sum, (bh, d)), ("ko_sum", ko_sum, (bh, d)),
                           ("kv", kv, (bh, d, d))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be fp32 of shape {shape}, got "
                             f"{x.dtype} {tuple(x.shape)} (the kernel takes "
                             "D == Dv)")


def flow_nc_fused_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       eps: float = 1e-6, use_comp: bool = True) -> torch.Tensor:
    """The whole non-causal Flow-Attention pair (K6), sigmoid phi and
    allocation.

    q: (BH, NQ, D) raw; k: (BH, M, D); v: (BH, M, Dv), NQ counting the sinks
    (G*N after grouping) -> (BH, NQ, Dv) in q's dtype.  On CUDA, D == Dv
    and BH <= 65,535; one launch of ``cluster_blocks(NQ, M, D)``-block
    clusters (``flow_nc_fused_parallel`` at that ``cb`` is its
    decomposition).
    """
    if q.device.type == "cpu":
        return flow_nc_fused_ref(q, k, v, eps=eps, use_comp=use_comp)
    _check_rows(q, k, v)
    _check(q.device, q=q, k=k, v=v)
    bh, nq, d = q.shape
    m = k.shape[1]
    if k.shape != (bh, m, d) or v.shape != (bh, m, d) or m < 1:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} (the kernel takes D == Dv)")
    if bh > 65535:
        raise ValueError(f"BH = {bh}: the kernel's grid takes at most 65,535 "
                         "(batch * kv head) rows")
    _lib.refuse_autograd(q, k, v, why="the flow_nc_fused kernel's output has "
                         "no autograd graph", instead="flow_attention_nc "
                         "(FlowNCFused, backward kernel K7b)")
    out = torch.empty_like(q)
    fn = _lib.function("flow_nc_fused", "flow_nc_fused_fwd", _FUSED_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, nq,
             m, d, d, DTYPE_CODES[q.dtype], cluster_blocks(nq, m, d),
             int(use_comp), eps, stream)
    _lib.check(fn, err, "flow_nc_fused")
    LAUNCHES["flow_nc_fused"] += 1
    return out


def flow_nc_qside_call(q: torch.Tensor, k_sum: torch.Tensor,
                       ko_sum: torch.Tensor, kv: torch.Tensor, *,
                       n_sinks: int, m_sources: int,
                       eps: float = 1e-6) -> torch.Tensor:
    """The sink side (K7a).  q: (BH, N, D); k_sum/ko_sum: (BH, D) and kv:
    (BH, D, Dv) fp32 -> (BH, N, Dv) in q's dtype."""
    if q.device.type == "cpu":
        return flow_nc_qside_ref(q, k_sum, ko_sum, kv, n_sinks=n_sinks,
                                 m_sources=m_sources, eps=eps)
    _check_rows(q)
    _check_key_side(q, k_sum, ko_sum, kv)
    _check(q.device, q=q, k_sum=k_sum, ko_sum=ko_sum, kv=kv)
    _lib.refuse_autograd(q, k_sum, ko_sum, kv, why="the flow_nc_qside "
                         "kernel's output has no autograd graph",
                         instead="FlowNCQside (backward kernel K7b)")
    bh, n, d = q.shape
    out = torch.empty_like(q)
    fn = _lib.function("flow_nc_qside", "flow_nc_qside_fwd", _QSIDE_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_sum.data_ptr(), ko_sum.data_ptr(), kv.data_ptr(),
             out.data_ptr(), bh, n, d, d, DTYPE_CODES[q.dtype],
             float(n_sinks) / float(m_sources), eps, stream)
    _lib.check(fn, err, "flow_nc_qside")
    LAUNCHES["flow_nc_qside"] += 1
    return out


def bwd_rows(bh: int, n: int, d: int, dtype: torch.dtype) -> int:
    """Rows of one (batch * head) per K7b block on the current card, from
    the library's ``flow_nc_qside_bwd_rows``: whole tiles, as few blocks as
    fill its SMs once."""
    rows = _lib.function("flow_nc_qside", "flow_nc_qside_bwd_rows", [_I] * 4)(
        bh, n, d, DTYPE_CODES[dtype])
    if rows < 1:
        raise ValueError(f"flow_nc_qside_bwd refuses BH={bh}, N={n}, D={d}, "
                         f"{dtype}")
    return rows


def flow_nc_qside_bwd_call(q: torch.Tensor, k_sum: torch.Tensor,
                           ko_sum: torch.Tensor, kv: torch.Tensor,
                           g: torch.Tensor, *, n_sinks: int, m_sources: int,
                           eps: float = 1e-6):
    """Cotangents of ``flow_nc_qside_call`` w.r.t. (q, k_sum, ko_sum, kv)
    for the output cotangent g (BH, N, Dv) in q's dtype (K7b).  Returns
    (dq in q's dtype, dk_sum, dko_sum, dkv fp32).  Each block owns
    ``bwd_rows`` rows of a (batch * head); the reductions over N add the
    blocks' partials in a fixed order (``ref.py::flow_nc_qside_bwd_parallel``
    is that decomposition), by a second launch over a scratch of
    ceil(N / rows) partials of 2 D + D Dv floats per row of the batch, so
    the result is the same on every run."""
    if q.device.type == "cpu":
        return flow_nc_qside_bwd_ref(q, k_sum, ko_sum, kv, g, n_sinks=n_sinks,
                                     m_sources=m_sources, eps=eps)
    _check_rows(q, g)
    _check_key_side(q, k_sum, ko_sum, kv)
    _check(q.device, q=q, k_sum=k_sum, ko_sum=ko_sum, kv=kv, g=g)
    bh, n, d = q.shape
    if g.shape != q.shape:
        raise ValueError(f"g has shape {tuple(g.shape)}, want {tuple(q.shape)}")
    rows = bwd_rows(bh, n, d, q.dtype)
    splits = -(-n // rows)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    part = torch.empty((bh, splits, 2 * d + d * d), **f32)
    dk_sum, dko_sum = torch.empty((bh, d), **f32), torch.empty((bh, d), **f32)
    dkv = torch.empty((bh, d, d), **f32)
    fn = _lib.function("flow_nc_qside", "flow_nc_qside_bwd",
                       _QSIDE_BWD_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_sum.data_ptr(), ko_sum.data_ptr(), kv.data_ptr(),
             g.data_ptr(), dq.data_ptr(), part.data_ptr(), dk_sum.data_ptr(),
             dko_sum.data_ptr(), dkv.data_ptr(), bh, n, d, d, rows,
             DTYPE_CODES[q.dtype], float(n_sinks) / float(m_sources), eps,
             stream)
    _lib.check(fn, err, "flow_nc_qside_bwd")
    LAUNCHES["flow_nc_qside_bwd"] += 1
    return dq, dk_sum, dko_sum, dkv


def flow_attention_nc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg: FlowConfig = FlowConfig()) -> torch.Tensor:
    """Non-causal Flow-Attention through K6 (shared-GQA semantics).

    q: (B, Hq, N, D); k, v: (B, Hkv, M, D/Dv) -> (B, Hq, N, Dv).  Sigmoid
    phi and allocation; ``cfg.use_competition`` and ``cfg.eps`` are read.
    Differentiable: the backward runs K7b (``FlowNCFused``).
    """
    from repro_torch.attention.vjp import FlowNCFused  # lazy: cycle

    b, hq, n, d = q.shape
    hkv, m = k.shape[1], k.shape[2]
    g = hq // hkv
    dv = v.shape[-1]
    qg = _group(q, hkv).reshape(b * hkv, g * n, d).contiguous()
    out = FlowNCFused.apply(qg, k.reshape(b * hkv, m, d).contiguous(),
                            v.reshape(b * hkv, m, dv).contiguous(), cfg.eps,
                            cfg.use_competition)
    return out.reshape(b, hkv, g, n, dv).reshape(b, hq, n, dv)
