"""Wrappers of the SSD chunk CUDA kernels: K10a (``csrc/ssd_chunk.cu``)
and K10b (``csrc/ssd_chunk_bwd.cu``), and the differentiable scan.

* ``ssd_chunk_call`` (K10a): the decay-gated chunk scan; with
  ``return_hins`` it also writes each chunk's carry-in (the variant
  counted as ``ssd_chunk_hins``);
* ``ssd_chunk_bwd_call`` (K10b): dx, ddta, db and dc from the saved
  carry-ins;
* ``SSDChunkDot``: K10a with carry-ins forward, K10b backward -- the
  counterpart of ``repro/kernels/ssd_chunk/ops.py::ssd_chunk_dot``;
* ``ssd_scan``: the head-batched scan of ``ssd_scan_pallas``.

B and C are shared by the heads of a batch row, and the kernels take
them once: (B, N, S) with x (B*H, N, P), or a (B, H, N, S) view with head
stride 0 (``bmat[:, None].expand(B, H, N, S)``).  Any other (B, H, N, S)
tensor is refused, rather than read as head 0.  K10a forms c b^T once per
(batch, chunk); K10b sums its db and dc over the heads in fixed orders and
returns them (B, N, S).  One wrapper call launches four CUDA kernels
(K10a) or seven (K10b) and counts one launch.

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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGTYPES = [_P] * 7 + [_I] * 6 + [_L] * 4 + [_P]
_BWD_ARGTYPES = [_P] * 11 + [_I] * 6 + [_L] * 4 + [_P]

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


def shared_bc(t: torch.Tensor, bh: int) -> torch.Tensor:
    """The (B, N, S) rows of b or c that the bh / B heads of a batch row
    share: ``t`` itself, or head 0 of a (B, H, N, S) view whose head
    stride is 0; raises on any other (B, H, N, S) tensor."""
    if t.ndim == 4:
        if t.shape[0] * t.shape[1] != bh:
            raise ValueError(f"b/c (B, H, N, S) needs B*H = {bh}, got "
                             f"{tuple(t.shape)}")
        if t.shape[1] > 1 and t.stride(1) != 0:
            raise ValueError("b/c (B, H, N, S) must be a view with head "
                             "stride 0 (shared by the heads), got strides "
                             f"{t.stride()}: pass the (B, N, S) rows")
        return t[:, 0]
    if t.ndim != 3 or not t.shape[0] or bh % t.shape[0]:
        raise ValueError(f"b/c must be (B, N, S) with B dividing {bh}, or "
                         f"a (B, H, N, S) view, got {tuple(t.shape)}")
    return t


def _check(x, dta, b, c, chunk, *others):
    """Raise unless the operands are what the SSD kernels take; returns
    (BH, N, P, S) and the shared (B, N, S) b and c."""
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
    bs, cs = shared_bc(b, bh), shared_bc(c, bh)
    if bs.shape != cs.shape or bs.shape[1:] != (n, s):
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} must "
                         f"share their (B, {n}, {s}) rows")
    for t in (bs, cs):
        sb, sn, sl = t.stride()
        if sl != 1 or sb % 4 or sn % 4 or t.data_ptr() % 16:
            raise ValueError("b/c rows must be contiguous with 16-byte "
                             f"aligned rows, got strides {t.stride()}")
    return (bh, n, p, s), bs, cs


def _workspace(x, size: int) -> torch.Tensor:
    """fp32 scratch of ``size`` floats (16-byte aligned, as the allocator
    gives); ``size`` < 0 is the kernel's refusal."""
    if size < 0:
        raise ValueError("ssd_chunk kernels refuse these shapes")
    return torch.empty(max(size, 4), dtype=torch.float32, device=x.device)


def ssd_chunk_call(x: torch.Tensor, dta: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, chunk: int = 128,
                   return_hins: bool = False):
    """K10a.  x: (BH, N, P) pre-scaled by dt; dta: (BH, N, 1); b, c: (B,
    N, S) shared by the BH / B heads of each batch row, or (B, H, N, S)
    views with head stride 0.  Returns y (BH, N, P); with ``return_hins``
    also the carry-ins (BH, N / chunk, P, S), fp32."""
    if x.device.type == "cpu":
        for t in (b, c):  # refused here as on the card
            shared_bc(t, x.shape[0])
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
        size = _lib.function("ssd_chunk", "ssd_chunk_fwd_workspace",
                             [_I] * 7, ctypes.c_longlong)
        work = _workspace(x, size(bh, bs.shape[0], n, p, s, chunk,
                                  int(return_hins)))
        fn = _lib.function("ssd_chunk", "ssd_chunk_fwd", _FWD_ARGTYPES)
        err = fn(x.data_ptr(), dta.data_ptr(), bs.data_ptr(), cs.data_ptr(),
                 y.data_ptr(), hins.data_ptr() if return_hins else None,
                 work.data_ptr(), bh, bs.shape[0], n, p, s, chunk,
                 *bs.stride()[:2], *cs.stride()[:2],
                 torch.cuda.current_stream(x.device).cuda_stream)
        _lib.check(fn, err, "ssd_chunk")
        LAUNCHES["ssd_chunk_hins" if return_hins else "ssd_chunk"] += 1
    return (y, hins) if return_hins else y


def ssd_chunk_bwd_call(x: torch.Tensor, dta: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, hins: torch.Tensor, g: torch.Tensor,
                       *, chunk: int = 128):
    """K10b: gradients of ``ssd_chunk_call`` w.r.t. (x, dta, b, c) for the
    cotangent g (BH, N, P), from the carry-ins hins (BH, N / chunk, P, S).
    Returns (dx, ddta, db, dc); db and dc are (B, N, S), summed over the
    heads of each batch row."""
    if x.device.type == "cpu":
        for t in (b, c):  # refused here as on the card
            shared_bc(t, x.shape[0])
        return ssd_chunk_bwd_ref(x, dta, b, c, hins, g, chunk=chunk)
    (bh, n, p, s), bs, cs = _check(x, dta, b, c, chunk, hins, g)
    if hins.shape != (bh, n // chunk, p, s) or g.shape != x.shape:
        raise ValueError(f"hins {tuple(hins.shape)} or g {tuple(g.shape)} "
                         f"do not match x {tuple(x.shape)}, chunk {chunk}")
    dx, ddta = torch.empty_like(x), torch.empty_like(dta)
    db = torch.empty(bs.shape, dtype=torch.float32, device=x.device)
    dc = torch.empty(cs.shape, dtype=torch.float32, device=x.device)
    if bh and n:
        size = _lib.function("ssd_chunk_bwd", "ssd_chunk_bwd_workspace",
                             [_I] * 6, ctypes.c_longlong)
        work = _workspace(x, size(bh, bs.shape[0], n, p, s, chunk))
        fn = _lib.function("ssd_chunk_bwd", "ssd_chunk_bwd", _BWD_ARGTYPES)
        err = fn(x.data_ptr(), dta.data_ptr(), bs.data_ptr(), cs.data_ptr(),
                 hins.data_ptr(), g.data_ptr(), dx.data_ptr(),
                 ddta.data_ptr(), db.data_ptr(), dc.data_ptr(),
                 work.data_ptr(), bh, bs.shape[0], n, p, s, chunk,
                 *bs.stride()[:2], *cs.stride()[:2],
                 torch.cuda.current_stream(x.device).cuda_stream)
        _lib.check(fn, err, "ssd_chunk_bwd")
        LAUNCHES["ssd_chunk_bwd"] += 1
    return dx, ddta, db, dc


class SSDChunkDot(torch.autograd.Function):
    """Differentiable K10a: the forward keeps (x, dta, b, c) and the
    carry-ins, nothing (B, H, N)-sized beyond them; the backward is K10b.
    b and c are the (B, N, S) rows the heads share, so their gradients
    come back summed over the heads."""

    @staticmethod
    def forward(ctx, x, dta, b, c, chunk: int):
        """y = ssd_chunk_call(x, dta, b, c) with the carry-ins saved."""
        if b.ndim != 3 or c.ndim != 3:
            raise ValueError("SSDChunkDot takes b and c as (B, N, S), got "
                             f"{tuple(b.shape)} and {tuple(c.shape)}")
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
    c = scan_chunk(n, chunk)
    x = (xh.float() * dt[..., None]).transpose(1, 2).reshape(bsz * h, n, p)
    dta = (dt * a[None, None, :]).transpose(1, 2).reshape(bsz * h, n, 1)
    if interpret:
        y, _ = ssd_chunk_chunked(x, dta, bmat, cmat, c)
    elif torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dta, bmat, cmat)):
        y = SSDChunkDot.apply(x, dta, bmat, cmat, c)
    else:
        y = ssd_chunk_call(x, dta, bmat, cmat, chunk=c)
    return y.reshape(bsz, h, n, p).transpose(1, 2)
