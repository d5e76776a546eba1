"""Wrappers of the flow_chunk CUDA kernels: K5a (``csrc/flow_chunk.cu``,
``csrc/flow_chunk_wide.cu``) and K5b (``csrc/flow_chunk_bwd.cu``,
``csrc/flow_chunk_bwd_wide.cu``), at the (D, Dv) pairs of
``_lib.CHUNK_PAIRS``: each wrapper launches from the narrow library at D
and Dv in ``HEAD_DIMS`` and from the wide one at the wide pairs, one count
either way.

* ``flow_chunk_call`` (K5a): ``out[g, i] = q[g, i] . sum_{j<=i} k_j^T v_j``
  over a flat (BH, G, N, D) batch -- the forward, and dq with k and v
  swapped;
* ``flow_chunk_dkv_call`` (K5b): dk and dv, the same three stages with the
  chunk order reversed.

The kernels take fp32 only: the causal pipeline hands the dot fp32
operands whatever the activation dtype (``attention/pipeline.py``), so
bf16 is refused by name.  Any N >= 1 is taken (rows past N are never
read); the glue (``attention/_cuda.py``) pads to the chunk as the
reference does.  CPU tensors run the plain versions (``ref.py``,
``bwd.py``), uncounted; CUDA tensors launch the kernel or raise.  K5a's
output records no autograd history, so on CUDA it refuses inputs that
autograd would differentiate outside ``attention/vjp.py::FlowChunkDot``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._lib import (CHUNK_PAIRS, HEAD_DIMS, LAUNCHES,
                                      PAIR_LAUNCHES)
from repro_torch.kernels.flow_chunk.bwd import flow_chunk_dkv_ref
from repro_torch.kernels.flow_chunk.ref import flow_chunk_ref

__all__ = ["LAUNCHES", "PAIR_LAUNCHES", "check_dims", "flow_chunk_call",
           "flow_chunk_dkv_call"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P] * 5 + [_I] * 5 + [_P]
_DKV_ARGTYPES = [_P] * 7 + [_I] * 5 + [_P]


def check_dims(d: int, dv: int) -> str | None:
    """Why the flow_chunk kernels refuse key width ``d`` and value width
    ``dv`` (``_lib.CHUNK_PAIRS``), or None.  Shared memory holds for every
    pair at any G (the kernels loop over the group)."""
    if (d, dv) not in CHUNK_PAIRS:
        wide = tuple(p for p in CHUNK_PAIRS if max(p) > max(HEAD_DIMS))
        return (f"kernel takes D and Dv in {HEAD_DIMS}, or (D, Dv) in "
                f"{wide}, got D={d} Dv={dv}")
    return None


def _entry(d: int, dv: int, narrow: tuple[str, str],
           wide: tuple[str, str], argtypes):
    """The C entry (source, symbol) launching at (d, dv): ``narrow`` at D
    and Dv in ``HEAD_DIMS``, else ``wide``."""
    source, symbol = narrow if d in HEAD_DIMS and dv in HEAD_DIMS else wide
    return _lib.function(source, symbol, argtypes)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *others: torch.Tensor):
    """Raise unless q (BH, G, N, D), k (BH, N, D), v (BH, N, Dv) and
    ``others`` (g: (BH, G, N, Dv)) are what the kernels take.  Returns
    (BH, G, N, D, Dv)."""
    if q.device.type != "cuda":
        raise ValueError(f"flow_chunk runs on cuda or cpu, not {q.device}")
    xs = (q, k, v, *others)
    if any(x.dtype != torch.float32 for x in xs):
        raise ValueError("flow_chunk kernels take fp32 only (the causal "
                         "pipeline's dot operands are fp32), got "
                         + "/".join(str(x.dtype) for x in xs))
    for x in xs:
        if x.device != q.device:
            raise ValueError(f"an operand is on {x.device}, q on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte aligned")
    if q.ndim != 4:
        raise ValueError(f"q must be (BH, G, N, D), got {tuple(q.shape)}")
    bh, g, n, d = q.shape
    dv = v.shape[-1]
    if k.shape != (bh, n, d) or v.shape != (bh, n, dv) or g < 1 or n < 1:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    why = check_dims(d, dv)
    if why:
        raise ValueError(why)
    return bh, g, n, d, dv


def workspace(q: torch.Tensor, bh: int, g: int, n: int, d: int, dv: int,
              source: str = "flow_chunk",
              symbol: str = "flow_chunk_workspace") -> torch.Tensor:
    """The fp32 scratch K5a (or, by ``source`` and ``symbol``, K5b) needs at
    these shapes (its chunk states), from the narrow library's own count,
    which covers every pair; the kernels allocate nothing."""
    size = _lib.function(source, symbol, [_I] * 5, ctypes.c_longlong)(
        bh, g, n, d, dv)
    if size < 0:
        raise ValueError(f"{source} refuses G={g}, N={n}, D={d}, Dv={dv}")
    return torch.empty(max(size, 4), dtype=torch.float32, device=q.device)


def flow_chunk_call(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The causal dot (K5a).  q: (BH, G, N, D); k: (BH, N, D); v: (BH, N,
    Dv) -> (BH, G, N, Dv) in q's dtype.  One call is one count in
    ``LAUNCHES`` (and in ``PAIR_LAUNCHES`` at (D, Dv)) and up to three
    CUDA kernels (chunk states, their prefix, the per-chunk products) on
    one ``workspace``."""
    if q.device.type == "cpu":
        return flow_chunk_ref(q, k, v)
    bh, g, n, d, dv = _check(q, k, v)
    _lib.refuse_autograd(q, k, v, why="the flow_chunk kernel's output has no "
                         "autograd graph", instead="FlowChunkDot (backward "
                         "kernels K5a and K5b)")
    out = torch.empty((bh, g, n, dv), dtype=q.dtype, device=q.device)
    if bh == 0:
        return out
    work = workspace(q, bh, g, n, d, dv)
    fn = _entry(d, dv, ("flow_chunk", "flow_chunk_fwd"),
                ("flow_chunk_wide", "flow_chunk_wide_fwd"), _FWD_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             work.data_ptr(), bh, g, n, d, dv, stream)
    _lib.check(fn, err, "flow_chunk")
    LAUNCHES["flow_chunk"] += 1
    PAIR_LAUNCHES[f"flow_chunk_{d}x{dv}"] += 1
    return out


def flow_chunk_dkv_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor):
    """dk and dv of the causal dot for its output cotangent g (K5b).

    q: (BH, G, N, D); k: (BH, N, D); v: (BH, N, Dv); g: (BH, G, N, Dv) ->
    dk (BH, N, D), dv (BH, N, Dv).  One call is one count in ``LAUNCHES``
    (and in ``PAIR_LAUNCHES`` at (D, Dv)) and up to three CUDA kernels
    (chunk states, their suffix, the per-chunk products;
    ``bwd.py::flow_chunk_dkv_parallel`` is that decomposition) on one
    ``workspace``, every sum in a fixed order.
    """
    if q.device.type == "cpu":
        return flow_chunk_dkv_ref(q, k, v, g)
    bh, grp, n, d, dv = _check(q, k, v, g)
    if g.shape != (bh, grp, n, dv):
        raise ValueError(f"g has shape {tuple(g.shape)}, want "
                         f"{(bh, grp, n, dv)}")
    dk, dvv = torch.empty_like(k), torch.empty_like(v)
    if bh == 0:
        return dk, dvv
    work = workspace(q, bh, grp, n, d, dv, "flow_chunk_bwd",
                     "flow_chunk_dkv_workspace")
    fn = _entry(d, dv, ("flow_chunk_bwd", "flow_chunk_dkv"),
                ("flow_chunk_bwd_wide", "flow_chunk_dkv_wide"), _DKV_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             dk.data_ptr(), dvv.data_ptr(), work.data_ptr(), bh, grp, n, d, dv,
             stream)
    _lib.check(fn, err, "flow_chunk_dkv")
    LAUNCHES["flow_chunk_dkv"] += 1
    PAIR_LAUNCHES[f"flow_chunk_dkv_{d}x{dv}"] += 1
    return dk, dvv
