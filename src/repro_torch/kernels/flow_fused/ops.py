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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.attention.fused import effective_chunk, pad_seq, padded_len
from repro_torch.attention.recurrent import FlowState
from repro_torch.core.flow_attention import FlowConfig, _group, _ungroup
from repro_torch.kernels import _lib
from repro_torch.kernels._lib import DTYPE_CODES, HEAD_DIMS, LAUNCHES, PHI_CODES
from repro_torch.kernels.flow_fused.ref import flow_fused_ref

__all__ = ["LAUNCHES", "flow_fused_call", "flow_fused_forward"]

_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                            ctypes.c_void_p]


def workspace(name: str, q: torch.Tensor, bh: int, g: int, n: int,
              d: int) -> torch.Tensor:
    """The fp32 scratch the kernels of source ``name`` (``flow_fused`` or
    ``flow_fused_bwd``) need at these shapes, from the library's own
    ``<symbol>_workspace`` count; the kernels allocate nothing."""
    symbol = {"flow_fused": "flow_fused_fwd"}.get(name, name) + "_workspace"
    size = _lib.function(name, symbol, [ctypes.c_int] * 4, ctypes.c_longlong)(
        bh, g, n, d)
    if size < 0:
        raise ValueError(f"{name} refuses G={g}, N={n}, D={d}")
    return torch.empty(max(size, 4), dtype=torch.float32, device=q.device)


def check_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lens: torch.Tensor, phi: str):
    """Raise unless (q, k, v, lens) are what the flow_fused kernels take:
    one CUDA device, contiguous, fp32 or bf16 alike, flat shapes, D == Dv
    in ``HEAD_DIMS``.  Returns (BH, G, N, D)."""
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
    if d != dv or d not in HEAD_DIMS:
        raise ValueError(f"kernel takes D == Dv in {HEAD_DIMS}, got {d}/{dv}")
    if phi not in PHI_CODES:
        raise ValueError(f"unknown phi {phi!r}")
    return bh, g, n, d


_DENSE = "flow_fused_forward without lengths (FlowFusedDot, backward kernel K2)"


def flow_fused_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lens: torch.Tensor, *, chunk: int = 128, eps: float = 1e-6,
                    phi: str = "sigmoid", use_alloc: bool = True):
    """Fused strict-causal Flow-Attention over a chunk-padded flat batch.

    q: (BH, G, N, D); k: (BH, N, D); v: (BH, N, Dv); lens: (BH,) int32
    with 1 <= lens <= N; N % chunk == 0.  Returns (out (BH, G, N, Dv),
    (q_sum, k_sum, ko_sum, qi_sum) each (BH, D) fp32, z (BH,) fp32,
    s (BH, D, Dv) fp32).  On CUDA it raises for inputs autograd would
    differentiate (``_lib.refuse_autograd``); the kernel runs its own
    chunk and super-chunk (``csrc/flow_fused.cu``), so ``chunk`` only sets
    the padding, and its scratch (per-position flows, chunk states) is one
    ``workspace``.  One call is one count in ``LAUNCHES`` and four CUDA
    kernels.
    """
    if q.shape[2] % chunk:
        raise ValueError(f"N={q.shape[2]} is not a multiple of chunk={chunk}")
    if q.device.type == "cpu":
        return flow_fused_ref(q, k, v, lens, chunk=chunk, eps=eps, phi=phi,
                              use_alloc=use_alloc)
    bh, g, n, d = check_flat(q, k, v, lens, phi)
    dv = d
    _lib.refuse_autograd(q, k, v, why="the flow_fused kernel's output has "
                         "no autograd graph", instead=_DENSE)

    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((bh, g, n, dv), dtype=q.dtype, device=q.device)
    sums = torch.empty((4, bh, d), **f32)
    z = torch.empty((bh,), **f32)
    s = torch.empty((bh, d, dv), **f32)
    work = workspace("flow_fused", q, bh, g, n, d)
    fn = _lib.function("flow_fused", "flow_fused_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
             out.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
             sums[2].data_ptr(), sums[3].data_ptr(), z.data_ptr(),
             s.data_ptr(), work.data_ptr(), bh, g, n, d, dv,
             DTYPE_CODES[q.dtype], PHI_CODES[phi], int(use_alloc), eps, stream)
    _lib.check(fn, err, "flow_fused")
    LAUNCHES["flow_fused"] += 1
    return out, (sums[0], sums[1], sums[2], sums[3], z, s)


def flow_fused_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cfg: FlowConfig, *, return_state: bool = False,
                       lengths: torch.Tensor | None = None):
    """Strict-causal Flow-Attention through the flow_fused kernel.

    q: (B, Hq, N, D); k/v: (B, Hkv, N, D/Dv), Hq divisible by Hkv (shared
    GQA).  ``lengths`` (B,) gives each row's valid length for packed
    prefill; that path is forward-only and raises for inputs autograd
    would differentiate.  Returns ``(out, state)``; ``state`` is the
    boundary ``FlowState`` when ``return_state`` else None.
    """
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    dv = v.shape[-1]
    grp = hq // hkv
    c = effective_chunk(n, cfg.chunk_size)
    n_pad = padded_len(n, c)
    qf = pad_seq(_group(q, hkv).reshape(b * hkv, grp, n, d), n_pad, 2)
    kf = pad_seq(k.reshape(b * hkv, n, d), n_pad, 1)
    vf = pad_seq(v.reshape(b * hkv, n, dv), n_pad, 1)
    qf, kf, vf = qf.contiguous(), kf.contiguous(), vf.contiguous()
    if lengths is None:
        from repro_torch.attention.vjp import FlowFusedDot  # lazy: cycle

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
