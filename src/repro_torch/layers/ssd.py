"""Mamba-2 block via SSD, state-space duality (arXiv:2405.21060).

The counterpart of ``repro/layers/ssd.py``.  Per head (head_dim P, state
S) the recurrence

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) outer B_t
    y_t = h_t @ C_t + D x_t

is computed in the chunked dual form: within a chunk a decay-masked
(C B^T) panel times dt x, across chunks exp(cum) (C h) and the carried
state.  Which code runs, as in the reference (``ssd.py:186``):

  * a stateless forward (training, evaluation) on a CUDA tensor goes to
    ``kernels.ssd_chunk.ssd_scan``: K10a and, under autograd, K10b.  There
    is no other route on the card: a shape the kernels refuse raises;
  * elsewhere, and for prefill from a state, the chunked scan in plain
    PyTorch (``_ssd_scan_chunked``); decode is the plain recurrence.

Packed prefill (``lengths``) zeroes dt past each row's boundary, so the
scan's carry freezes there and the final carry is each row's boundary
state; the conv histories of the x, B and C streams are gathered per
row by one K9 launch (``kernels.gather.boundary_gather_many``).  Conv
histories are stored in ``CONV_DTYPE``, bf16 whatever the activation
dtype, as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.gather import boundary_gather_many
from repro_torch.kernels.ssd_chunk import ssd_scan
from repro_torch.layers import mixer as mixer_lib
from repro_torch.layers.linear import dense, dense_init
from repro_torch.layers.norms import apply_norm, norm_init
from repro_torch.layers.rglru import _causal_conv
from repro_torch.utils import lecun_normal, resolve_device


#: the decode conv histories' storage dtype (``repro/layers/ssd.py:203,262``)
CONV_DTYPE = torch.bfloat16


class SSDState(NamedTuple):
    h: torch.Tensor  # (B, H, P, S) ssm state, fp32
    conv: tuple  # (x, B, C) trailing inputs of the causal convs, CONV_DTYPE


def _dims(cfg: ModelConfig):
    s = cfg.ssd
    d_in = s.expand * cfg.d_model
    return s, d_in, d_in // s.head_dim


def _log_uniform(gen: torch.Generator, n: int, lo: float, hi: float):
    u = torch.rand((n,), generator=gen)
    return torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)


def ssd_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Parameters with the reference's shapes and initializer families."""
    s, d_in, nh = _dims(cfg)
    d = cfg.d_model
    a = _log_uniform(gen, nh, *s.a_init_range)
    return {
        "in_z": dense_init(gen, d, d_in),
        "in_x": dense_init(gen, d, d_in),
        "in_b": dense_init(gen, d, s.d_state),
        "in_c": dense_init(gen, d, s.d_state),
        "in_dt": dense_init(gen, d, nh),
        "conv_x_w": lecun_normal(gen, (s.conv_width, d_in)) * 0.1,
        "conv_x_b": torch.zeros((d_in,)),
        "conv_b_w": lecun_normal(gen, (s.conv_width, s.d_state)) * 0.1,
        "conv_b_b": torch.zeros((s.d_state,)),
        "conv_c_w": lecun_normal(gen, (s.conv_width, s.d_state)) * 0.1,
        "conv_c_b": torch.zeros((s.d_state,)),
        "a_log": torch.log(a),
        "dt_bias": torch.log(torch.expm1(_log_uniform(gen, nh, 1e-3, 1e-1))),
        "d_skip": torch.ones((nh,)),
        "norm": norm_init(d_in, "rmsnorm"),
        "out_proj": dense_init(gen, d_in, d),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_in(params, x: torch.Tensor):
    return (dense(params["in_z"], x), dense(params["in_x"], x),
            dense(params["in_b"], x), dense(params["in_c"], x),
            dense(params["in_dt"], x))


def _conv_all(params, xh, bmat, cmat, hist):
    """Depthwise causal conv per component; hist = (hx, hb, hc) or None."""
    hx, hb, hc = (None, None, None) if hist is None else hist
    xh, nx = _causal_conv(xh, params["conv_x_w"], params["conv_x_b"], hx)
    bmat, nb = _causal_conv(bmat, params["conv_b_w"], params["conv_b_b"], hb)
    cmat, nc = _causal_conv(cmat, params["conv_c_w"], params["conv_c_b"], hc)
    return xh, bmat, cmat, (nx, nb, nc)


def _ssd_scan_chunked(xh, dt, bmat, cmat, a, chunk: int):
    """Chunked SSD in plain PyTorch.  xh: (B, N, H, P); dt: (B, N, H) fp32;
    bmat/cmat: (B, N, S) fp32; a: (H,) negative.  Returns y (B, N, H, P)
    and the final state (B, H, P, S), fp32."""
    bsz, n, h, p = xh.shape
    sdim = bmat.shape[-1]
    c = min(chunk, n)
    while n % c:
        c //= 2
    xr = xh.reshape(bsz, n // c, c, h, p)
    dtr = dt.reshape(bsz, n // c, c, h)
    br = bmat.reshape(bsz, n // c, c, sdim)
    cr = cmat.reshape(bsz, n // c, c, sdim)
    mask = torch.ones((c, c), dtype=torch.bool, device=xh.device).tril()
    hstate = torch.zeros((bsz, h, p, sdim), dtype=torch.float32,
                         device=xh.device)
    ys = []
    for k in range(n // c):
        xb, dtb, bb, cb = xr[:, k], dtr[:, k], br[:, k], cr[:, k]
        cum = torch.cumsum(dtb * a, dim=1)  # (B, c, H) inclusive
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, c, c, H)
        # clamp before exp: the upper triangle would overflow to inf
        decay = torch.where(mask[None, :, :, None],
                            torch.exp(torch.minimum(diff, torch.zeros_like(
                                diff))),
                            torch.zeros((), device=xh.device))
        scores = torch.einsum("bis,bjs->bij", cb, bb)
        xdt = xb.float() * dtb[..., None]
        y_intra = torch.einsum("bijh,bjhp->bihp", scores[..., None] * decay,
                               xdt)
        y_inter = (torch.einsum("bis,bhps->bihp", cb, hstate)
                   * torch.exp(cum)[..., None])
        seg = torch.exp(cum[:, -1:, :] - cum)
        hstate = (hstate * torch.exp(cum[:, -1])[:, :, None, None]
                  + torch.einsum("bjhp,bjs->bhps", xdt * seg[..., None], bb))
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1).reshape(bsz, n, h, p), hstate


def _ssd_scan_chunked_with_init(xh, dt, bmat, cmat, a, chunk, h0):
    if h0 is None:
        return _ssd_scan_chunked(xh, dt, bmat, cmat, a, chunk)
    y, hf = _ssd_scan_chunked(xh, dt, bmat, cmat, a, chunk)
    # the initial state's contribution decays through every position
    cum = torch.cumsum(dt * a, dim=1)  # (B, N, H)
    y_init = (torch.einsum("bns,bhps->bnhp", cmat, h0)
              * torch.exp(cum)[..., None])
    hf = hf + h0 * torch.exp(cum[:, -1])[:, :, None, None]
    return y + y_init, hf


def _stored(hist: tuple) -> tuple:
    return tuple(t.to(CONV_DTYPE) for t in hist)


def _ssd_forward(params, x: torch.Tensor, cfg: ModelConfig,
                 state: SSDState | None, lengths=None):
    """x: (B, N, d_model) -> (out, new SSDState).  ``lengths`` (B,) packs
    right-padded prompts into one chunked scan: dt past each row's
    boundary is zeroed, so exp(dt A) = 1 and dt x = 0 there and the final
    carry is each row's boundary state; conv histories are gathered per
    row from the raw (pre-silu) component streams."""
    s, d_in, nh = _dims(cfg)
    bsz, n, _ = x.shape
    z, xh, bmat, cmat, dt = _split_in(params, x)
    raw = (xh, bmat, cmat)
    hist = None if state is None else state.conv
    xh, bmat, cmat, new_hist = _conv_all(params, xh, bmat, cmat, hist)
    xh, bmat, cmat = F.silu(xh), F.silu(bmat), F.silu(cmat)
    xh = xh.reshape(bsz, n, nh, s.head_dim)
    dt = _softplus(dt.float() + params["dt_bias"])  # (B, N, H)
    if lengths is not None:
        lengths = lengths.to(device=x.device, dtype=torch.int32)
        live = (torch.arange(n, device=x.device)[None, :]
                < lengths[:, None])
        dt = dt * live[..., None]
        new_hist = boundary_gather_many(raw, lengths, s.conv_width)
    a = -torch.exp(params["a_log"])  # (H,)
    if state is None and x.device.type == "cuda":
        # the stateless path on the card: K10a / K10b (state discarded)
        y = ssd_scan(xh, dt, bmat.float(), cmat.float(), a,
                     chunk=s.chunk_size)
        h_final = torch.zeros((bsz, nh, s.head_dim, s.d_state),
                              dtype=torch.float32, device=x.device)
    else:
        y, h_final = _ssd_scan_chunked_with_init(
            xh, dt, bmat.float(), cmat.float(), a, s.chunk_size,
            None if state is None else state.h)
    y = y + params["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, n, d_in).to(x.dtype)
    y = apply_norm(params["norm"], y * F.silu(z), "rmsnorm")
    return dense(params["out_proj"], y), SSDState(h_final, _stored(new_hist))


def ssd_block(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba-2 block.  x: (B, N, d_model)."""
    out, _ = _ssd_forward(params, x, cfg, state=None)
    return out


def _ssd_state_init(cfg: ModelConfig, batch: int,
                    device="cuda") -> SSDState:
    s, d_in, nh = _dims(cfg)
    device = resolve_device(device)
    k = s.conv_width - 1
    zeros = lambda *shape, dtype=CONV_DTYPE: torch.zeros(  # noqa: E731
        shape, dtype=dtype, device=device)
    return SSDState(h=zeros(batch, nh, s.head_dim, s.d_state,
                            dtype=torch.float32),
                    conv=(zeros(batch, k, d_in), zeros(batch, k, s.d_state),
                          zeros(batch, k, s.d_state)))


def _ssd_prefill(params, x: torch.Tensor, cfg: ModelConfig, lengths=None):
    state = _ssd_state_init(cfg, x.shape[0], device=x.device)
    return _ssd_forward(params, x, cfg, state, lengths=lengths)


def _ssd_decode(params, x: torch.Tensor, state: SSDState, cfg: ModelConfig):
    """One-token decode by the plain recurrence.  x: (B, 1, d_model)."""
    s, d_in, nh = _dims(cfg)
    bsz = x.shape[0]
    z, xh, bmat, cmat, dt = _split_in(params, x)
    xh, bmat, cmat, hist = _conv_all(params, xh, bmat, cmat, state.conv)
    xh, bmat, cmat = F.silu(xh), F.silu(bmat), F.silu(cmat)
    xh = xh.reshape(bsz, nh, s.head_dim)  # (B, H, P)
    dtv = _softplus(dt[:, 0].float() + params["dt_bias"])  # (B, H)
    decay = torch.exp(dtv * -torch.exp(params["a_log"]))
    bm, cm = bmat[:, 0].float(), cmat[:, 0].float()  # (B, S)
    h = state.h * decay[:, :, None, None] + torch.einsum(
        "bhp,bs->bhps", xh.float() * dtv[..., None], bm)
    y = torch.einsum("bhps,bs->bhp", h, cm)
    y = y + params["d_skip"][None, :, None] * xh.float()
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    y = apply_norm(params["norm"], y * F.silu(z), "rmsnorm")
    return dense(params["out_proj"], y), SSDState(h, _stored(hist))


class SSDMixer(mixer_lib.Mixer):
    """Mamba-2 SSD as a sequence mixer.  ``block_ffn = False``: the Mamba
    block is the whole layer (gated SSM and out-projection, no FFN)."""

    params_field = "ssd"
    block_ffn = False

    def packable(self, cfg):
        return True, ("boundary states via dt-masked chunked scan "
                      "+ per-row conv-history gathers")

    def differentiable(self, cfg, platform):
        if platform == "cuda":
            return True, ("ssd_chunk autograd.Function: reverse-scan CUDA "
                          "backward (K10b) off chunk-boundary carry-ins")
        return True, "chunked PyTorch scan is natively differentiable"

    def init_params(self, gen, cfg):
        return ssd_init(gen, cfg)

    def forward(self, params, x, cfg, *, positions=None, plan=None):
        return ssd_block(params, x, cfg)

    def state_init(self, cfg, batch, max_len, *, device="cuda", dtype=None,
                   plan=None):
        return _ssd_state_init(cfg, batch, device=device)

    def prefill(self, params, x, cfg, max_len, *, positions=None,
                lengths=None, plan=None):
        return _ssd_prefill(params, x, cfg, lengths=lengths)

    def decode_step(self, params, x, state, cfg, *, positions=None,
                    page_table=None, plan=None):
        return _ssd_decode(params, x, state, cfg)


mixer_lib.register_mixer("ssd", SSDMixer())
