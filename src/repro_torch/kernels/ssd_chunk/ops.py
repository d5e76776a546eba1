"""Wrappers of the SSD chunk CUDA kernels: K10a (``csrc/ssd_chunk.cu``)
and K10b (``csrc/ssd_chunk_bwd.cu``), and the differentiable scan.

* ``ssd_chunk_call`` (K10a): the decay-gated chunk scan; with
  ``return_hins`` it also writes each chunk's carry-in (the variant
  counted as ``ssd_chunk_hins``);
* ``ssd_chunk_bwd_call`` (K10b): the reverse chunk scan for dx, ddta, db
  and dc from the saved carry-ins;
* ``SSDChunkDot``: K10a with carry-ins forward, K10b backward -- the
  counterpart of ``repro/kernels/ssd_chunk/ops.py::ssd_chunk_dot``;
* ``ssd_scan``: the head-batched scan of ``ssd_scan_pallas``.

B and C are shared by the heads of a batch row.  The kernels read them
through strides, so ``ssd_scan`` passes ``bmat[:, None].expand(B, H, N,
S)``, a view with head stride 0: nothing (B*H, N, S)-sized is made in the
forward.  K10b writes db and dc per (b*h) row; autograd's ``expand``
backward sums them over the heads (no float atomics).

CPU tensors run the plain versions (``ref.py``, ``bwd.py``), uncounted;
CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._lib import LAUNCHES
from repro_torch.kernels.ssd_chunk.bwd import ssd_chunk_bwd_ref
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_chunked

__all__ = ["LAUNCHES", "SSDChunkDot", "check_dims", "scan_chunk",
           "ssd_chunk_bwd_call", "ssd_chunk_call", "ssd_scan"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P] * 6 + [_I] * 12 + [_P]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 12 + [_P]

#: what the kernels take: the (head width P, state width S) pairs of the
#: configs (mamba2_1p3b and its smoke config), chunks 1..128
WIDTHS = ((64, 128), (32, 32))
MAX_CHUNK = 128


def check_dims(p: int, s: int, chunk: int) -> str | None:
    """Why the SSD kernels refuse head width ``p``, state width ``s`` or
    ``chunk``, or None."""
    if (p, s) not in WIDTHS:
        return f"kernel takes (P, S) in {WIDTHS}, got P={p} S={s}"
    if not 1 <= chunk <= MAX_CHUNK:
        return f"kernel takes chunks of 1..{MAX_CHUNK}, got {chunk}"
    return None


def scan_chunk(n: int, chunk: int) -> int:
    """``ssd_scan``'s chunk for N positions: min(chunk, N), halved until it
    divides N (``repro/kernels/ssd_chunk/ops.py:65-67``)."""
    c = min(chunk, n)
    while n % c:
        c //= 2
    return c


def _bc_strides(t: torch.Tensor, bh: int, n: int, s: int):
    """(heads, batch stride, head stride, position stride) of b or c, a
    (BH, N, S) tensor or a (B, H, N, S) view; raises on what the kernel
    does not take."""
    if t.ndim == 3 and t.shape == (bh, n, s):
        heads, (sb, sn, sl), sh = 1, t.stride(), 0
    elif t.ndim == 4 and t.shape[0] * t.shape[1] == bh and t.shape[2:] == (n, s):
        heads, (sb, sh, sn, sl) = t.shape[1], t.stride()
    else:
        raise ValueError(f"b/c must be ({bh}, {n}, {s}) or (B, H, {n}, {s}) "
                         f"with B*H = {bh}, got {tuple(t.shape)}")
    if sl != 1 or sb % 4 or sh % 4 or sn % 4 or t.data_ptr() % 16:
        raise ValueError("b/c rows must be contiguous with 16-byte aligned "
                         f"rows, got strides {t.stride()}")
    return heads, sb, sh, sn


def _check(x, dta, b, c, chunk, *others):
    """Raise unless the operands are what the SSD kernels take; returns
    (BH, N, P, S) and b's and c's stride descriptors."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cuda or cpu, not {x.device}")
    xs = (x, dta, b, c, *others)
    if any(t.dtype != torch.float32 for t in xs):
        raise ValueError("ssd_chunk kernels take fp32 only, got "
                         + "/".join(str(t.dtype) for t in xs))
    if any(t.device != x.device for t in xs):
        raise ValueError("ssd_chunk operands must share one device")
    if x.ndim != 3:
        raise ValueError(f"x must be (BH, N, P), got {tuple(x.shape)}")
    bh, n, p = x.shape
    s = b.shape[-1]
    if dta.shape != (bh, n, 1):
        raise ValueError(f"dta must be ({bh}, {n}, 1), got {tuple(dta.shape)}")
    for t in (x, dta, *others):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("x, dta, hins and g must be contiguous and "
                             "16-byte aligned")
    why = check_dims(p, s, chunk)
    if why:
        raise ValueError(why)
    if n % chunk:
        raise ValueError(f"N = {n} is not a multiple of chunk = {chunk}")
    bs, cs = _bc_strides(b, bh, n, s), _bc_strides(c, bh, n, s)
    if bs[0] != cs[0]:
        raise ValueError("b and c must share their head layout")
    return (bh, n, p, s), bs, cs


def ssd_chunk_call(x: torch.Tensor, dta: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, chunk: int = 128,
                   return_hins: bool = False):
    """K10a.  x: (BH, N, P) pre-scaled by dt; dta: (BH, N, 1); b, c: (BH,
    N, S) or (B, H, N, S) views.  Returns y (BH, N, P); with
    ``return_hins`` also the carry-ins (BH, N / chunk, P, S), fp32."""
    if x.device.type == "cpu":
        y, hins = ssd_chunk_chunked(x, dta, b, c, chunk)
        return (y, hins) if return_hins else y
    (bh, n, p, s), bs, cs = _check(x, dta, b, c, chunk)
    _lib.refuse_autograd(x, dta, b, c, why="the ssd_chunk kernel's output "
                         "has no autograd graph", instead="SSDChunkDot "
                         "(backward kernel K10b)")
    y = torch.empty_like(x)
    hins = (torch.empty((bh, n // chunk, p, s), dtype=torch.float32,
                        device=x.device) if return_hins else None)
    if bh and n:
        fn = _lib.function("ssd_chunk", "ssd_chunk_fwd", _FWD_ARGTYPES)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dta.data_ptr(), b.data_ptr(), c.data_ptr(),
                 y.data_ptr(), hins.data_ptr() if return_hins else None,
                 bh, bs[0], n, p, s, chunk, *bs[1:], *cs[1:], stream)
        _lib.check(fn, err, "ssd_chunk")
        LAUNCHES["ssd_chunk_hins" if return_hins else "ssd_chunk"] += 1
    return (y, hins) if return_hins else y


def ssd_chunk_bwd_call(x: torch.Tensor, dta: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, hins: torch.Tensor, g: torch.Tensor,
                       *, chunk: int = 128):
    """K10b: gradients of ``ssd_chunk_call`` w.r.t. (x, dta, b, c) for the
    cotangent g (BH, N, P), from the carry-ins hins (BH, N / chunk, P, S).
    Returns (dx, ddta, db, dc); db and dc per (b*h) row, shaped like b
    and c."""
    if x.device.type == "cpu":
        return ssd_chunk_bwd_ref(x, dta, b, c, hins, g, chunk=chunk)
    (bh, n, p, s), bs, cs = _check(x, dta, b, c, chunk, hins, g)
    if hins.shape != (bh, n // chunk, p, s) or g.shape != x.shape:
        raise ValueError(f"hins {tuple(hins.shape)} or g {tuple(g.shape)} "
                         f"do not match x {tuple(x.shape)}, chunk {chunk}")
    dx, ddta = torch.empty_like(x), torch.empty_like(dta)
    db = torch.empty(b.shape, dtype=torch.float32, device=x.device)
    dc = torch.empty(c.shape, dtype=torch.float32, device=x.device)
    if bh and n:
        fn = _lib.function("ssd_chunk_bwd", "ssd_chunk_bwd", _BWD_ARGTYPES)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dta.data_ptr(), b.data_ptr(), c.data_ptr(),
                 hins.data_ptr(), g.data_ptr(), dx.data_ptr(),
                 ddta.data_ptr(), db.data_ptr(), dc.data_ptr(), bh, bs[0], n,
                 p, s, chunk, *bs[1:], *cs[1:], stream)
        _lib.check(fn, err, "ssd_chunk_bwd")
        LAUNCHES["ssd_chunk_bwd"] += 1
    return dx, ddta, db, dc


class SSDChunkDot(torch.autograd.Function):
    """Differentiable K10a: the forward keeps (x, dta, b, c) and the
    carry-ins, nothing (B, H, N)-sized beyond them; the backward is K10b."""

    @staticmethod
    def forward(ctx, x, dta, b, c, chunk: int):
        """y = ssd_chunk_call(x, dta, b, c) with the carry-ins saved."""
        y, hins = ssd_chunk_call(x, dta, b, c, chunk=chunk, return_hins=True)
        ctx.save_for_backward(x, dta, b, c, hins)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, g):
        """K10b on the saved carry-ins."""
        x, dta, b, c, hins = ctx.saved_tensors
        dx, ddta, db, dc = ssd_chunk_bwd_call(x, dta, b, c, hins,
                                              g.contiguous(), chunk=ctx.chunk)
        return dx, ddta, db, dc, None


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, a: torch.Tensor, *, chunk: int = 128,
             interpret: bool | None = None) -> torch.Tensor:
    """Head-batched SSD scan (``ssd_scan_pallas``).

    xh: (B, N, H, P); dt: (B, N, H) fp32 (softplus applied); bmat/cmat:
    (B, N, S) fp32, shared across heads; a: (H,) negative.  Returns y
    (B, N, H, P) fp32, without the D-skip term.  The chunk is
    ``scan_chunk(N, chunk)``.  ``interpret=None`` runs the kernels on a
    CUDA tensor (K10a with carry-ins and K10b where autograd records, K10a
    alone where it does not) and the plain versions through the same
    glue on a CPU one; ``interpret=True`` runs the plain chunked scan on
    any device, under autograd, uncounted.
    """
    bsz, n, h, p = xh.shape
    s = bmat.shape[-1]
    c = scan_chunk(n, chunk)
    x = (xh.float() * dt[..., None]).transpose(1, 2).reshape(bsz * h, n, p)
    dta = (dt * a[None, None, :]).transpose(1, 2).reshape(bsz * h, n, 1)
    bm = bmat[:, None].expand(bsz, h, n, s)
    cm = cmat[:, None].expand(bsz, h, n, s)
    if interpret:
        y, _ = ssd_chunk_chunked(x, dta, bm, cm, c)
    elif torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dta, bm, cm)):
        y = SSDChunkDot.apply(x, dta, bm, cm, c)
    else:
        y = ssd_chunk_call(x, dta, bm, cm, chunk=c)
    return y.reshape(bsz, h, n, p).transpose(1, 2)
