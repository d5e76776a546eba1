"""Wrapper of the flow_fused CUDA kernel (``csrc/flow_fused.cu``).

``flow_fused_call`` works on the kernel's flat (BH, G, N, D) layout;
``flow_fused_forward`` groups, pads and flattens (B, Hq, N, D) inputs and
reassembles the output and the boundary ``FlowState`` around it, as
``repro/kernels/flow_fused/ops.py`` does around the TPU kernel.  CPU
tensors run the plain version (``ref.py``); CUDA tensors launch the kernel.

The dense path (``lengths=None``) goes through ``attention/vjp.py::
FlowFusedDot``, whose backward is the K2 kernel (``bwd.py``).  The packed
path (per-row ``lengths``) is forward-only serving prefill, as in the
reference.  The kernel's output records no autograd history, so the CUDA
path refuses inputs that autograd would differentiate rather than cut the
gradient silently.

Beside D == Dv in ``HEAD_DIMS`` the kernel and its backward K2 take
``_lib.WIDE_PAIRS`` (D = 192 with Dv = 128 or 192: the MLA and
Nemotron-4-340B heads; D = Dv = 256: RecurrentGemma's) in instantiations
of their own.  At D = 256 the flows of a large group do not fit a block's
shared memory (G > 21): the workspace count refuses such a G, naming D
and G.  K2's pull-back takes fewer (``_lib.k2_group_fits``: 9-10 at D <=
128, 23 at 192, 21 at 256; at D <= 128 K1 takes larger groups
forward-only): on CUDA, ``flow_fused_forward`` refuses to start a forward
that autograd would differentiate at a group K2 does not take, naming
K2, D and G, instead of failing in the backward.

Two routes serve shapes the kernel's instantiations do not:

* a head dim in ``_lib.PADDED_HEAD_DIMS`` (the Table 7 harness's D = 24):
  ``flow_fused_call`` and ``flow_fused_bwd_call`` zero-pad their operands
  to the stored width (32) and hand the C entry the real width, so phi is
  0 on the padded lanes; the results are sliced back to D.  Every caller,
  and the plain versions, see D alone;
* ``chunk_size <= 0`` (``flowformer_dt``): in strict-causal mode the
  result does not depend on the chunk, so N is padded to a multiple of the
  kernels' own chunk (``_lib.kernel_chunk``: 60 -> 64, 180 -> 192) and
  ``lens`` masks the tail.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.attention.fused import pad_seq, padded_len
from repro_torch.attention.recurrent import FlowState
from repro_torch.core.flow_attention import FlowConfig, _group, _ungroup
from repro_torch.kernels import _lib
from repro_torch.kernels._lib import (DTYPE_CODES, HEAD_DIMS, LAUNCHES,
                                      PADDED_HEAD_DIMS, PHI_CODES, WIDE_PAIRS,
                                      kernel_chunk, pad_lanes, stored_width)
from repro_torch.kernels.flow_fused.ref import flow_fused_ref

__all__ = ["LAUNCHES", "flow_fused_call", "flow_fused_forward"]

_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                            ctypes.c_void_p]


def workspace(name: str, q: torch.Tensor, bh: int, g: int, n: int,
              *dims: int) -> torch.Tensor:
    """The fp32 scratch the kernels of source ``name`` need at these
    shapes, from the library's own ``<symbol>_workspace`` count (``dims``:
    D and Dv); the kernels allocate nothing."""
    symbol = {"flow_fused": "flow_fused_fwd"}.get(name, name) + "_workspace"
    size = _lib.function(name, symbol, [ctypes.c_int] * (3 + len(dims)),
                         ctypes.c_longlong)(bh, g, n, *dims)
    if size < 0:
        raise ValueError(f"{name} refuses G={g}, N={n}, D/Dv={dims}: no "
                         "instantiation takes the shape, or the group's "
                         "flows (or pull-back) do not fit a block's shared "
                         "memory at this D")
    return torch.empty(max(size, 4), dtype=torch.float32, device=q.device)


def check_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lens: torch.Tensor, phi: str):
    """Raise unless (q, k, v, lens) are what the flow_fused wrappers (K1
    and K2) take: one CUDA device, contiguous, fp32 or bf16 alike, flat
    shapes, D == Dv in ``HEAD_DIMS`` or ``PADDED_HEAD_DIMS``, or a (D, Dv)
    of ``WIDE_PAIRS``.  Returns (BH, G, N, D)."""
    bh, g, n, d = q.shape
    dv = v.shape[-1]
    if q.device.type != "cuda":
        raise ValueError(f"flow_fused runs on cuda or cpu, not {q.device}")
    for name, x in (("k", k), ("v", v), ("lens", lens)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v), ("lens", lens)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share fp32 or bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if lens.dtype != torch.int32 or lens.shape != (bh,):
        raise ValueError(f"lens must be int32 of shape ({bh},)")
    if k.shape != (bh, n, d) or v.shape != (bh, n, dv):
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if not takes(d, dv):
        raise ValueError(f"kernel takes D == Dv in {HEAD_DIMS} or "
                         f"{tuple(PADDED_HEAD_DIMS)}, or (D, Dv) in "
                         f"{WIDE_PAIRS}, got {d}/{dv}")
    if phi not in PHI_CODES:
        raise ValueError(f"unknown phi {phi!r}")
    return bh, g, n, d


def takes(d: int, dv: int) -> bool:
    """Whether K1 and K2 have a route at (D, Dv)."""
    return (d == dv and stored_width(d) in HEAD_DIMS) or (d, dv) in WIDE_PAIRS


_DENSE = "flow_fused_forward without lengths (FlowFusedDot, backward kernel K2)"


def flow_fused_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lens: torch.Tensor, *, chunk: int = 128, eps: float = 1e-6,
                    phi: str = "sigmoid", use_alloc: bool = True):
    """Fused strict-causal Flow-Attention over a chunk-padded flat batch.

    q: (BH, G, N, D); k: (BH, N, D); v: (BH, N, Dv); lens: (BH,) int32
    with 1 <= lens <= N; N % chunk == 0.  Returns (out (BH, G, N, Dv),
    (q_sum, k_sum, ko_sum, qi_sum) each (BH, D) fp32, z (BH,) fp32,
    s (BH, D, Dv) fp32).  A D of ``PADDED_HEAD_DIMS`` runs on its stored
    width (see the module's docstring).  On CUDA it raises for inputs
    autograd would differentiate (``_lib.refuse_autograd``); the kernel
    runs its own chunk and super-chunk (``csrc/flow_fused.cu``), so
    ``chunk`` only sets the padding, and its scratch (per-position flows,
    chunk states) is one ``workspace``.  One call is one count in
    ``LAUNCHES`` and four CUDA kernels.
    """
    if q.shape[2] % chunk:
        raise ValueError(f"N={q.shape[2]} is not a multiple of chunk={chunk}")
    if q.device.type == "cpu":
        return flow_fused_ref(q, k, v, lens, chunk=chunk, eps=eps, phi=phi,
                              use_alloc=use_alloc)
    bh, g, n, d = check_flat(q, k, v, lens, phi)
    dv = v.shape[-1]
    _lib.refuse_autograd(q, k, v, why="the flow_fused kernel's output has "
                         "no autograd graph", instead=_DENSE)
    w, wv = stored_width(d), stored_width(dv)
    q, k, v = (pad_lanes(x) for x in (q, k, v))

    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((bh, g, n, wv), dtype=q.dtype, device=q.device)
    sums = torch.empty((4, bh, w), **f32)
    z = torch.empty((bh,), **f32)
    s = torch.empty((bh, w, wv), **f32)
    work = workspace("flow_fused", q, bh, g, n, d, dv)
    fn = _lib.function("flow_fused", "flow_fused_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
             out.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
             sums[2].data_ptr(), sums[3].data_ptr(), z.data_ptr(),
             s.data_ptr(), work.data_ptr(), bh, g, n, d, dv,
             DTYPE_CODES[q.dtype], PHI_CODES[phi], int(use_alloc), eps, stream)
    _lib.check(fn, err, "flow_fused")
    LAUNCHES["flow_fused"] += 1
    if (w, wv) != (d, dv):  # the real lanes of the padded route
        out = out[..., :dv].contiguous()
        sums, s = sums[..., :d].contiguous(), s[:, :d, :dv].contiguous()
    return out, (sums[0], sums[1], sums[2], sums[3], z, s)


def flow_fused_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cfg: FlowConfig, *, return_state: bool = False,
                       lengths: torch.Tensor | None = None):
    """Strict-causal Flow-Attention through the flow_fused kernel.

    q: (B, Hq, N, D); k/v: (B, Hkv, N, D/Dv), Hq divisible by Hkv (shared
    GQA).  ``lengths`` (B,) gives each row's valid length for packed
    prefill; that path is forward-only and raises for inputs autograd
    would differentiate.  N is padded to ``_lib.kernel_chunk``'s multiple
    and sliced off again.  Returns ``(out, state)``; ``state`` is the
    boundary ``FlowState`` when ``return_state`` else None.
    """
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    dv = v.shape[-1]
    grp = hq // hkv
    c = kernel_chunk(n, cfg.chunk_size, d, dv)
    n_pad = padded_len(n, c)
    qf = pad_seq(_group(q, hkv).reshape(b * hkv, grp, n, d), n_pad, 2)
    kf = pad_seq(k.reshape(b * hkv, n, d), n_pad, 1)
    vf = pad_seq(v.reshape(b * hkv, n, dv), n_pad, 1)
    qf, kf, vf = qf.contiguous(), kf.contiguous(), vf.contiguous()
    if lengths is None:
        from repro_torch.attention.vjp import FlowFusedDot  # lazy: cycle

        if (q.device.type == "cuda" and not _lib.k2_group_fits(d, grp)
                and torch.is_grad_enabled()
                and any(x.requires_grad for x in (q, k, v))):
            raise RuntimeError(
                f"the backward kernel K2 (flow_fused_bwd) does not take "
                f"G={grp} at D={d}: its pull-back does not fit a block's "
                "shared memory")

        t = torch.full((b,), n, dtype=torch.int32, device=q.device)
        out, *sums = FlowFusedDot.apply(qf, kf, vf, n, c, cfg.eps, cfg.phi,
                                        cfg.use_allocation)
    else:
        _lib.refuse_autograd(q, k, v, why="packed prefill (lengths=) is "
                             "forward-only serving, as in the reference",
                             instead=_DENSE)
        t = lengths.to(device=q.device, dtype=torch.int32).clamp(1, n)
        out, sums = flow_fused_call(qf, kf, vf, t.repeat_interleave(hkv),
                                    chunk=c, eps=cfg.eps, phi=cfg.phi,
                                    use_alloc=cfg.use_allocation)
    out = _ungroup(out[:, :, :n].reshape(b, hkv, grp, n, dv))
    if not return_state:
        return out, None
    q_sum, k_sum, ko_sum, qi_sum, z, s = sums
    return out, FlowState(
        t=t,
        q_sum=q_sum.reshape(b, hkv, d),
        k_sum=k_sum.reshape(b, hkv, d),
        ko_sum=ko_sum.reshape(b, hkv, d),
        qi_sum=qi_sum.reshape(b, hkv, d),
        z=z.reshape(b, hkv),
        s=s.reshape(b, hkv, d, dv),
    )
