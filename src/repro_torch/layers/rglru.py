"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The counterpart of ``repro/layers/rglru.py``.  The Real-Gated Linear
Recurrent Unit

    r_t = sigmoid(W_a x_t)            recurrence gate (block-diagonal)
    i_t = sigmoid(W_x x_t)            input gate      (block-diagonal)
    log a_t = -c r_t softplus(Lambda)                  (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

wrapped in the Griffin recurrent block: two input projections, a short
causal depthwise conv on the recurrent branch, GeLU (tanh approximation,
as ``jax.nn.gelu``) gating on the other, and an output projection.  The
diagonal recurrence is a log-depth scan in plain PyTorch (``_scan``), as
the reference's is ``jax.lax.associative_scan`` in plain XLA; decode
carries (h, the conv history).

The mixer registers as ``rglru``.  Packed prefill freezes the gates past
each row's length (a = 1, b = 0), so the scan's last carry is each row's
boundary state, and gathers each row's conv history at its boundary (K9,
``kernels.gather.boundary_gather``, on a CUDA tensor).  Conv histories
are stored bf16 whatever the activation dtype, as in the reference.  An
int8 pool (``serving/quant.py``) is dequantized, advanced in fp32 and
requantized with a fresh amax each step.

``_causal_conv`` and ``_softplus`` are shared with ``layers/ssd.py``,
which imports them from here as the reference's does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.gather import boundary_gather
from repro_torch.layers import mixer as mixer_lib
from repro_torch.layers.linear import dense, dense_init
from repro_torch.serving import quant as quant_lib
from repro_torch.utils import lecun_normal, resolve_device

_C = 8.0
#: the decode conv history's storage dtype (``repro/layers/rglru.py:118``)
CONV_DTYPE = torch.bfloat16


class RGLRUState(NamedTuple):
    h: torch.Tensor  # (B, W) recurrent state, fp32
    conv: torch.Tensor  # (B, conv_width - 1, W) trailing conv inputs, bf16


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Parameters with the reference's shapes, initializer families and
    draw order; ``lam`` spans a = sigmoid(lam)^c over (0.9, 0.999)."""
    d, w, nb = cfg.d_model, _width(cfg), cfg.rglru.n_blocks
    bw = w // nb
    dev = gen.device
    a = torch.linspace(0.9, 0.999, w, device=dev)
    return {
        "w_x": dense_init(gen, d, w),
        "w_gate": dense_init(gen, d, w),
        "conv_w": lecun_normal(gen, (cfg.rglru.conv_width, w)) * 0.1,
        "conv_b": torch.zeros((w,), dtype=torch.float32, device=dev),
        "gate_a": lecun_normal(gen, (nb, bw, bw)),
        "gate_x": lecun_normal(gen, (nb, bw, bw)),
        "lam": torch.log(torch.expm1(a ** (-1.0 / _C) - 1.0)),
        "w_out": dense_init(gen, w, d),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _block_proj(w_blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block-diagonal projection of x (..., W), W = nb * bw, in x's dtype."""
    nb, bw, _ = w_blocks.shape
    xs = x.reshape(*x.shape[:-1], nb, bw)
    y = torch.einsum("...nb,nbc->...nc", xs, w_blocks.to(x.dtype))
    return y.reshape(x.shape)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: torch.Tensor | None = None):
    """Depthwise causal conv along time.  x: (B, N, W); w: (K, W); b: (W,);
    history: the (B, K-1, W) inputs before x, zeros when None.  Returns
    (y (B, N, W), the last K-1 inputs).  A sum of K shifted products in
    x's dtype, as the reference writes it (no cuDNN conv, which would run
    fp32 in TF32)."""
    k, n = w.shape[0], x.shape[1]
    if history is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = history.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, N+K-1, W)
    y = sum(xp[:, i:i + n] * w[i].to(x.dtype) for i in range(k))
    return y + b.to(x.dtype), xp[:, xp.shape[1] - (k - 1):]


def _rglru_gates(params, xc: torch.Tensor):
    """(a, b) fp32 of the recurrence h = a h + b at every position."""
    r = torch.sigmoid(_block_proj(params["gate_a"], xc).float())
    i = torch.sigmoid(_block_proj(params["gate_x"], xc).float())
    log_a = -_C * r * _softplus(params["lam"].float())  # (B, N, W)
    a = torch.exp(log_a)
    gated_x = i * xc.float()
    # the sqrt(1 - a^2) input normalizer (Griffin eq. 5), stable via expm1
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, beta * gated_x


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, fp32.

    A Hillis-Steele scan: ceil(log2 N) rounds, round j combining each
    position t >= 2^j with the partial of t - 2^j, (a, b) <- (a_{t-2^j}
    a_t, a_t b_{t-2^j} + b_t), each product and sum rounded once in fp32.
    So h_t is summed over t's positions in a binary tree of spans that
    double each round (the reference's ``associative_scan`` sums a tree of
    its own: the two agree to fp32 rounding, not bitwise).  O(N log N)
    elementwise work in whole-tensor ops, no loop over positions.
    """
    n = a.shape[1]
    off = 1
    while off < n:
        a_prev, b_prev = a[:, :n - off], b[:, :n - off]
        b = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a_prev * a[:, off:]], dim=1)
        off *= 2
    return b


def _branches(params, x: torch.Tensor, history=None):
    """The block's input branches: the conv input xb, the GeLU gate, the
    conv output xc and its last K-1 inputs."""
    xb = dense(params["w_x"], x)
    gb = _gelu(dense(params["w_gate"], x))
    xc, hist = _causal_conv(xb, params["conv_w"], params["conv_b"], history)
    return xb, gb, xc, hist


def rglru_block(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Griffin recurrent block.  x: (B, N, d_model)."""
    _, gb, xc, _ = _branches(params, x)
    h = _scan(*_rglru_gates(params, xc)).to(x.dtype)
    return dense(params["w_out"], h * gb)


def _rglru_state_init(cfg: ModelConfig, batch: int,
                      device="cuda") -> RGLRUState:
    w, dev = _width(cfg), resolve_device(device)
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=dev),
        conv=torch.zeros((batch, cfg.rglru.conv_width - 1, w),
                         dtype=CONV_DTYPE, device=dev))


def _rglru_prefill(params, x: torch.Tensor, cfg: ModelConfig,
                   lengths: torch.Tensor | None = None):
    """Prompt prefill returning (out, RGLRUState).  ``lengths`` (B,) packs
    right-padded prompts into the same scan: the gates at positions >=
    lengths[i] are the identity (a = 1, b = 0), so the carry, and with it
    ``h[:, -1]``, is each row's boundary state, and the conv history is
    gathered at each row's own boundary.  True positions are untouched
    (the scan is causal); padded outputs are never read."""
    xb, gb, xc, hist = _branches(params, x)
    a, b = _rglru_gates(params, xc)
    if lengths is not None:
        pos = torch.arange(x.shape[1], device=x.device)
        pad = (pos[None, :] >= lengths.to(device=x.device,
                                          dtype=torch.long)[:, None])[..., None]
        a = torch.where(pad, 1.0, a)
        b = torch.where(pad, 0.0, b)
    h = _scan(a, b)
    out = dense(params["w_out"], h.to(x.dtype) * gb)
    if lengths is not None:
        # each row's last K-1 inputs before its length, zero-filled on the
        # left as a fresh pad: K9 on a CUDA tensor
        hist = boundary_gather(xb, lengths, cfg.rglru.conv_width)
    return out, RGLRUState(h=h[:, -1], conv=hist.to(CONV_DTYPE))


def _rglru_decode(params, x: torch.Tensor, state: RGLRUState,
                  cfg: ModelConfig):
    """One-token decode.  x: (B, 1, d_model)."""
    _, gb, xc, hist = _branches(params, x, state.conv)
    a, b = _rglru_gates(params, xc)
    h = a[:, 0] * state.h + b[:, 0]
    out = dense(params["w_out"], h[:, None].to(x.dtype) * gb)
    return out, RGLRUState(h=h, conv=hist.to(CONV_DTYPE))


class RGLRUMixer(mixer_lib.Mixer):
    """Griffin's RG-LRU as a sequence mixer (followed by the block's FFN)."""

    params_field = "rglru"

    def packable(self, cfg):
        return True, ("boundary states via identity-frozen scan gates "
                      "+ per-row conv-history gather")

    def quant_capable(self, cfg, platform, dtype):
        ok, why = quant_lib.platform_support(dtype, platform)
        if not ok:
            return False, why
        return True, ("dequantize -> fp32 diagonal recurrence -> "
                      f"requantize per step ({why})")

    def init_params(self, gen, cfg):
        return rglru_init(gen, cfg)

    def forward(self, params, x, cfg, *, positions=None, plan=None):
        return rglru_block(params, x, cfg)

    def state_init(self, cfg, batch, max_len, *, device="cuda", dtype=None,
                   plan=None):
        return quant_lib.maybe_quantize(
            _rglru_state_init(cfg, batch, device=device), plan)

    def prefill(self, params, x, cfg, max_len, *, positions=None,
                lengths=None, plan=None):
        return _rglru_prefill(params, x, cfg, lengths=lengths)

    def decode_step(self, params, x, state, cfg, *, positions=None,
                    page_table=None, plan=None):
        if isinstance(state, quant_lib.QuantizedPool):
            # a constant-size state rewritten every step: the fp32 update
            # between a dequantize and a fresh-amax requantize
            out, new = _rglru_decode(params, x,
                                     quant_lib.dequantize_state(state), cfg)
            return out, quant_lib.quantize_like(state, new)
        return _rglru_decode(params, x, state, cfg)


mixer_lib.register_mixer("rglru", RGLRUMixer())
