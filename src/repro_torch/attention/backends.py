"""The registered Flow-Attention backends of the port.

Registration order is the ``backend="auto"`` preference order:

    cuda_nc > nc > cuda_fused > cuda_chunk > fused_causal > chunked
    > cumsum > cuda_decode > recurrent

``cuda_nc``, ``cuda_fused``, ``cuda_chunk`` and ``cuda_decode`` are the
hand-written CUDA kernels (``kernels/flow_nc``, ``kernels/flow_fused``,
``kernels/flow_chunk``, ``kernels/flow_decode``) and apply only on a CUDA
device; ``nc``, ``fused_causal``, ``chunked``, ``cumsum`` and
``recurrent`` are plain PyTorch.  The non-causal pair serves
``causal=False`` plans only, the others causal ones.  ``cuda_fused`` and
``fused_causal`` carry the strict-causal competition in their scan;
``cuda_chunk``, ``chunked`` and ``cumsum`` run the unfused pipeline
(``pipeline.causal_forward``) around a causal dot -- K5a, the chunked
scan, a cumsum -- and so also serve the paper-faithful causal mode
(``strict_causal=False``) and the no-competition ablation.  On the CPU the
plain versions apply; on a CUDA device they apply only when pinned
(``backend="plain"`` or by name).  So ``auto`` resolves to the kernels on
a GPU, and a shape no kernel takes raises there with the kernel's own
reason instead of running the plain version unseen.

Gradient capability mirrors the reference's ``differentiable`` sets: the
plain versions are differentiated by autograd; ``cuda_nc`` differentiates
its forward through ``attention/vjp.py::FlowNCFused`` (K6 forward, K7b
backward); ``cuda_fused``
differentiates forward and prefill through ``attention/vjp.py::
FlowFusedDot`` (K1 forward, K2 backward) but not packed prefill, which is
forward-only serving as in the reference; ``cuda_chunk`` differentiates
all three through ``FlowChunkDot`` (K5a forward; K5a and K5b backward);
``cuda_decode`` updates the pool in place and differentiates nothing.

Quantized serving pools (``ExecutionPlan.state_dtype`` int8) reach only
the decode backends, the two that declare ``quant_capable`` as in the
reference: ``cuda_decode`` runs K4 (``kernels/flow_decode/quant.py``) on
the int8 pool in place, ``recurrent`` dequantizes, takes the fp32 step and
requantizes with the pool's recipe.  fp8 pools are refused off the TPU by
both, with ``serving/quant.py::platform_support``'s reason.

Speculative decoding's ``verify`` op (score a drafted window from a
FlowState, every position's boundary state returned for rollback) is
provided, as in the reference, by the chunked-scan strategies
``cuda_fused``, ``cuda_chunk``, ``chunked`` and ``cumsum``, each through
``pipeline.causal_verify``: the window is a handful of tokens, so its
carry-in cumsum pass is plain PyTorch tensor code on the card too (the
reference's Pallas backends verify in plain XLA the same way).  A window
meets no kernel or chunk shape check, every verify verdict says that no
kernel runs (``VERIFY_VERDICT``), and an int8 pool is dequantized once at
the window's entry (``_ChunkedVerifyQuant``).  ``recurrent`` also runs a
forward and a prefill token by token (``recurrent.forward_by_scan``, the
oracle), last in auto order and on a GPU only when pinned.
"""
from __future__ import annotations

import functools

from repro_torch.attention import fused, pipeline, recurrent
from repro_torch.attention.chunked import chunked_causal_dot_grouped
from repro_torch.attention.dots import causal_dot_grouped
from repro_torch.attention.registry import Backend, register_backend
from repro_torch.kernels._lib import HEAD_DIMS, NC_HEAD_DIMS
from repro_torch.kernels.flow_chunk.ops import check_dims
from repro_torch.serving.quant import (QuantizedPool, dequantize_state,
                                       platform_support, quantize_like)


def _check_causal_self(cfg, shapes, op="forward"):
    if not cfg.causal:
        return "causal-only backend"
    if op != "decode" and shapes.n != shapes.m:
        return f"causal requires N == M, got N={shapes.n} M={shapes.m}"
    return None


def _check_strict_causal(cfg, shapes, op):
    why = _check_causal_self(cfg, shapes, op)
    if why:
        return why
    if not cfg.strict_causal:
        return "implements the strict-causal cumulative competition only"
    if not cfg.use_competition:
        return "the carried state includes the competition normalizer"
    return None


def _check_state_ops(cfg, op):
    if op in ("prefill", "prefill_packed", "verify") and not (
            cfg.strict_causal and cfg.use_competition):
        return "recurrent state requires strict_causal competition"
    return None


VERIFY_VERDICT = ("pipeline.causal_verify: plain PyTorch carry-in verify "
                  "(no kernel)")


class _ChunkedVerifyQuant:
    """Mixin: the chunked-verify backends' ``verify`` op, which also serves
    quantized pools: ``pipeline.causal_verify`` dequantizes the pooled
    carry-in once at entry and runs the whole window in fp32, so any
    platform that can store the pool can verify from it."""

    def quant_capable(self, platform, dtype, op="decode"):
        if op != "verify":
            return super().quant_capable(platform, dtype, op)
        ok, why = platform_support(dtype, platform)
        if not ok:
            return False, why
        return True, ("boundary dequantize into the fp32 carry-in verify "
                      f"({why})")

    def verify_step(self, state, q, k, v, cfg):
        # a drafted window is a handful of tokens: the carry-in cumsum
        # pass is the right realization at any scale a draft produces, and
        # the trajectory it returns is what rollback gathers
        return pipeline.causal_verify(state, q, k, v, cfg)


def _check_plain(cfg, name, platform):
    if platform == "cuda" and cfg.backend not in ("plain", name):
        return ("plain PyTorch version: on a CUDA device it runs only when "
                "pinned (backend='plain' or by name)")
    return None


def _check_device(platform):
    if platform != "cuda":
        return f"CUDA backend needs a CUDA device (platform={platform!r})"
    return None


def _check_kernel(shapes, platform):
    if platform != "cuda":
        return f"CUDA kernel needs a CUDA device (platform={platform!r})"
    if shapes.d != shapes.dv or shapes.d not in HEAD_DIMS:
        return (f"kernel takes D == Dv in {HEAD_DIMS}, got "
                f"D={shapes.d} Dv={shapes.dv}")
    return None


def _check_nc_dims(shapes, platform):
    """The non-causal kernels' device and head dims (K6, K7a, K7b:
    ``NC_HEAD_DIMS``, wider than the causal kernels' ``HEAD_DIMS``)."""
    if platform != "cuda":
        return f"CUDA kernel needs a CUDA device (platform={platform!r})"
    if shapes.d != shapes.dv or shapes.d not in NC_HEAD_DIMS:
        return (f"kernel takes D == Dv in {NC_HEAD_DIMS}, got "
                f"D={shapes.d} Dv={shapes.dv}")
    return None


def _check_chunk_kernel(shapes, platform):
    if platform != "cuda":
        return f"CUDA kernel needs a CUDA device (platform={platform!r})"
    return check_dims(shapes.d, shapes.dv)


def _check_nc_kernel(cfg, shapes):
    """The reasons ``repro/attention/backends.py::PallasNC`` gives: the
    kernels hard-code sigmoid phi and allocation and shared GQA."""
    if cfg.causal:
        return "non-causal-only backend"
    if cfg.phi != "sigmoid":
        return f"kernel hard-codes sigmoid phi, cfg has {cfg.phi!r}"
    if not cfg.use_allocation:
        return "kernel hard-codes the allocation sigmoid"
    if cfg.gqa_mode != "shared" and shapes.hq != shapes.hkv:
        return "kernel implements shared-GQA semantics only"
    return None


def _check_scan(cfg, shapes, op):
    if cfg.chunk_size <= 0:
        return "chunk_size <= 0"
    return _check_strict_causal(cfg, shapes, op)


def _check_decode(cfg, shapes, op):
    if shapes.n != 1:
        return f"decode consumes one position, got N={shapes.n}"
    return _check_strict_causal(cfg, shapes, op)


class NonCausal(Backend):
    """Non-causal Flow-Attention (paper Eq. 4/7/8) in plain PyTorch: sums
    over all N sinks and M sources (``pipeline.nc_forward``)."""

    provides = frozenset({"forward"})
    differentiable = frozenset({"forward"})

    def supports(self, cfg, shapes, platform, *, op="forward"):
        why = (("non-causal-only backend" if cfg.causal else None)
               or _check_plain(cfg, self.name, platform))
        if why:
            return False, why
        return True, "non-causal flow attention"

    def forward(self, q, k, v, cfg):
        return pipeline.nc_forward(q, k, v, cfg)


class CudaNC(NonCausal):
    """The whole non-causal pair in the flow_nc_fused CUDA kernel (K6), one
    thread-block cluster per (batch, kv head) through the four phases; its
    backward runs K7b.  Head dims ``NC_HEAD_DIMS``: the vision and
    time-series encoders' small heads (6-48) too."""

    def supports(self, cfg, shapes, platform, *, op="forward"):
        why = (_check_nc_kernel(cfg, shapes)
               or _check_nc_dims(shapes, platform))
        if why:
            return False, why
        return True, "flow_nc CUDA kernels"

    def forward(self, q, k, v, cfg):
        from repro_torch.kernels.flow_nc import flow_attention_nc

        return flow_attention_nc(q, k, v, cfg)


class FusedCausal(Backend):
    """Strict-causal flows + cumulative competition + aggregation in one
    chunked scan whose carry is the decode ``FlowState`` (plain PyTorch)."""

    provides = frozenset({"forward", "prefill", "prefill_packed"})
    differentiable = frozenset({"forward", "prefill", "prefill_packed"})

    def supports(self, cfg, shapes, platform, *, op="forward"):
        why = (_check_scan(cfg, shapes, op)
               or _check_plain(cfg, self.name, platform))
        if why:
            return False, why
        return True, "fused strict-causal scan"

    def forward(self, q, k, v, cfg):
        k, v = pipeline.expand_kv(q, k, v, cfg)
        return fused.fused_causal_forward(q, k, v, cfg)

    def prefill(self, q, k, v, cfg, *, lengths=None):
        k, v = pipeline.expand_kv(q, k, v, cfg)
        return fused.fused_causal_forward(q, k, v, cfg, return_state=True,
                                          lengths=lengths)


class CudaFused(_ChunkedVerifyQuant, FusedCausal):
    """The whole strict-causal pipeline in the flow_fused CUDA kernel: one
    CTA per (row, kv head) with the FlowState in shared memory; packed
    prefill masks each row past its length so the final carry is the
    boundary FlowState.  Forward and prefill differentiate through the
    reverse-scan backward kernel K2.  ``verify`` runs
    ``pipeline.causal_verify``, plain PyTorch, at any head width."""

    provides = frozenset({"forward", "prefill", "prefill_packed", "verify"})
    differentiable = frozenset({"forward", "prefill"})

    def supports(self, cfg, shapes, platform, *, op="forward"):
        if op == "verify":
            # causal_verify launches no kernel, so no kernel shape applies
            why = _check_scan(cfg, shapes, op) or _check_device(platform)
            return (False, why) if why else (True, VERIFY_VERDICT)
        why = _check_scan(cfg, shapes, op) or _check_kernel(shapes, platform)
        if why:
            return False, why
        return True, "flow_fused CUDA kernel"

    def forward(self, q, k, v, cfg):
        from repro_torch.kernels.flow_fused import flow_fused_forward

        k, v = pipeline.expand_kv(q, k, v, cfg)
        return flow_fused_forward(q, k, v, cfg)[0]

    def prefill(self, q, k, v, cfg, *, lengths=None):
        from repro_torch.kernels.flow_fused import flow_fused_forward

        k, v = pipeline.expand_kv(q, k, v, cfg)
        return flow_fused_forward(q, k, v, cfg, return_state=True,
                                  lengths=lengths)


def _cumsum_dot(qg, k, v):
    return causal_dot_grouped(qg, k, v, chunk_size=0, use_kernel=False)


class Cumsum(_ChunkedVerifyQuant, Backend):
    """The causal pipeline on full-length cumsums (plain PyTorch): every
    causal mode at every shape, the causal half of the reference's
    ``xla_cumsum``.  O(N D Dv) memory in the dot."""

    provides = frozenset({"forward", "prefill", "prefill_packed", "verify"})
    differentiable = frozenset({"forward", "prefill", "prefill_packed"})
    verdict = "universal causal fallback"

    def supports(self, cfg, shapes, platform, *, op="forward"):
        why = (_check_causal_self(cfg, shapes) or _check_state_ops(cfg, op)
               or self._check_dot(cfg, shapes, platform, op))
        if why:
            return False, why
        return True, VERIFY_VERDICT if op == "verify" else self.verdict

    def _check_dot(self, cfg, shapes, platform, op):
        return _check_plain(cfg, self.name, platform)

    def _dot(self, cfg):
        return _cumsum_dot

    def forward(self, q, k, v, cfg):
        return pipeline.causal_forward(q, k, v, cfg, self._dot(cfg))

    def prefill(self, q, k, v, cfg, *, lengths=None):
        return pipeline.causal_forward(q, k, v, cfg, self._dot(cfg),
                                       return_state=True, lengths=lengths)


class Chunked(Cumsum):
    """The causal pipeline on the plain chunked scan
    (``attention/chunked.py``): N a multiple of the chunk, and longer."""

    verdict = "chunked scan"

    def _check_dot(self, cfg, shapes, platform, op):
        c = cfg.chunk_size
        if c <= 0:
            return "chunk_size <= 0"
        if op != "verify" and (shapes.n % c or shapes.n <= c):
            # a drafted verify window never goes through the blocked dot
            return f"N={shapes.n} not chunkable by chunk_size={c}"
        return _check_plain(cfg, self.name, platform)

    def _dot(self, cfg):
        return functools.partial(chunked_causal_dot_grouped,
                                 chunk_size=cfg.chunk_size)


class CudaChunk(Cumsum):
    """The causal pipeline on the flow_chunk CUDA kernel K5a (one block
    per (row, kv head) and Dv slice, the (D, Dv) state in shared memory),
    differentiated through ``FlowChunkDot`` (K5a for dq, K5b for dk and
    dv).  Any N: the glue pads to the chunk."""

    verdict = "flow_chunk CUDA kernels"

    def _check_dot(self, cfg, shapes, platform, op):
        if cfg.chunk_size <= 0:
            return "chunk_size <= 0"
        if op == "verify":
            return _check_device(platform)
        return _check_chunk_kernel(shapes, platform)

    def _dot(self, cfg):
        from repro_torch.attention._cuda import chunked_causal_dot_cuda

        return functools.partial(chunked_causal_dot_cuda,
                                 chunk=cfg.chunk_size)


class Recurrent(Backend):
    """The O(d^2) recurrence one token at a time (plain PyTorch); returns a
    new state.  Its forward and prefill run the same update token by token
    (``recurrent.forward_by_scan``), an oracle for tiny shapes."""

    provides = frozenset({"forward", "prefill", "decode"})
    differentiable = frozenset({"forward", "prefill", "decode"})

    def supports(self, cfg, shapes, platform, *, op="forward"):
        why = ((_check_decode(cfg, shapes, op) if op == "decode"
                else _check_strict_causal(cfg, shapes, op))
               or _check_plain(cfg, self.name, platform))
        if why:
            return False, why
        return True, "O(d^2) recurrence"

    def quant_capable(self, platform, dtype, op="decode"):
        if op != "decode":
            return super().quant_capable(platform, dtype, op)
        ok, why = platform_support(dtype, platform)
        if not ok:
            return False, why
        return True, f"dequantize -> fp32 recurrence -> requantize ({why})"

    def forward(self, q, k, v, cfg):
        k, v = pipeline.expand_kv(q, k, v, cfg)
        return recurrent.forward_by_scan(q, k, v, cfg)

    def prefill(self, q, k, v, cfg, *, lengths=None):
        if lengths is not None:
            raise ValueError("the token scan returns the final state only")
        k, v = pipeline.expand_kv(q, k, v, cfg)
        return recurrent.forward_by_scan(q, k, v, cfg, return_state=True)

    def decode_step(self, state, q, k, v, cfg):
        k, v = pipeline.expand_kv(q, k, v, cfg)
        if isinstance(state, QuantizedPool):
            # the plain version of the quantized hot path: the kernel's
            # per-(slot, head) scales, the update in fp32
            new, out = recurrent.decode_step(dequantize_state(state), q, k, v,
                                             cfg)
            return quantize_like(state, new), out
        return recurrent.decode_step(state, q, k, v, cfg)


class CudaDecode(Recurrent):
    """One flow_decode CUDA launch advances the whole (slots, Hkv) state
    pool in place: the serving hot loop.  An int8 ``QuantizedPool`` goes to
    flow_decode_q (K4) instead, dequantized, advanced and requantized in
    the kernel."""

    provides = frozenset({"decode"})
    differentiable = frozenset()

    def supports(self, cfg, shapes, platform, *, op="forward"):
        why = (_check_decode(cfg, shapes, op)
               or _check_kernel(shapes, platform))
        if why:
            return False, why
        return True, "flow_decode CUDA kernel, state updated in place"

    def quant_capable(self, platform, dtype, op="decode"):
        if op != "decode":
            return Backend.quant_capable(self, platform, dtype, op)
        ok, why = platform_support(dtype, platform)
        if not ok:
            return False, why
        return True, ("in-kernel dequantize / fp32 accumulate / requantize "
                      f"(flow_decode_q; {why})")

    def decode_step(self, state, q, k, v, cfg):
        from repro_torch.kernels.flow_decode import (flow_decode_q_step,
                                                     flow_decode_step)

        k, v = pipeline.expand_kv(q, k, v, cfg)
        if isinstance(state, QuantizedPool):
            return flow_decode_q_step(state, q, k, v, cfg)
        return flow_decode_step(state, q, k, v, cfg)


register_backend("cuda_nc", CudaNC())
register_backend("nc", NonCausal())
register_backend("cuda_fused", CudaFused())
register_backend("cuda_chunk", CudaChunk())
register_backend("fused_causal", FusedCausal())
register_backend("chunked", Chunked())
register_backend("cumsum", Cumsum())
register_backend("cuda_decode", CudaDecode())
register_backend("recurrent", Recurrent())
