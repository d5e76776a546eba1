"""The registered Flow-Attention backends of the port.

Registration order is the ``backend="auto"`` preference order:

    cuda_nc > nc > cuda_fused > fused_causal > cuda_decode > recurrent

``cuda_nc``, ``cuda_fused`` and ``cuda_decode`` are the hand-written CUDA
kernels (``kernels/flow_nc``, ``kernels/flow_fused``,
``kernels/flow_decode``) and apply only on a CUDA device; ``nc``,
``fused_causal`` and ``recurrent`` are their plain PyTorch versions.  The
non-causal pair serves ``causal=False`` plans only, the others causal
ones.  On the CPU the plain versions apply; on a CUDA device they
apply only when pinned (``backend="plain"`` or by name).  So ``auto``
resolves to the kernels on a GPU, and a shape no kernel takes raises
there with the kernel's own reason instead of running the plain version
unseen.

Gradient capability mirrors the reference's ``differentiable`` sets: the
plain versions are differentiated by autograd; ``cuda_nc`` differentiates
its forward through ``attention/vjp.py::FlowNCFused`` (K6 forward, K7a
and K7b backward); ``cuda_fused``
differentiates forward and prefill through ``attention/vjp.py::
FlowFusedDot`` (K1 forward, K2 backward) but not packed prefill, which is
forward-only serving as in the reference; ``cuda_decode`` updates the
pool in place and differentiates nothing.
"""
from __future__ import annotations

from repro_torch.attention import fused, pipeline, recurrent
from repro_torch.attention.registry import Backend, register_backend
from repro_torch.kernels._lib import HEAD_DIMS


def _check_strict_causal(cfg, shapes, op):
    if not cfg.causal:
        return "causal-only backend"
    if op != "decode" and shapes.n != shapes.m:
        return f"causal requires N == M, got N={shapes.n} M={shapes.m}"
    if not cfg.strict_causal:
        return "implements the strict-causal cumulative competition only"
    if not cfg.use_competition:
        return "the carried state includes the competition normalizer"
    return None


def _check_plain(cfg, name, platform):
    if platform == "cuda" and cfg.backend not in ("plain", name):
        return ("plain PyTorch version: on a CUDA device it runs only when "
                "pinned (backend='plain' or by name)")
    return None


def _check_kernel(shapes, platform):
    if platform != "cuda":
        return f"CUDA kernel needs a CUDA device (platform={platform!r})"
    if shapes.d != shapes.dv or shapes.d not in HEAD_DIMS:
        return (f"kernel takes D == Dv in {HEAD_DIMS}, got "
                f"D={shapes.d} Dv={shapes.dv}")
    return None


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
    block per (batch, kv head) looping over the four phases; its backward
    runs K7a and K7b."""

    def supports(self, cfg, shapes, platform, *, op="forward"):
        why = (_check_nc_kernel(cfg, shapes)
               or _check_kernel(shapes, platform))
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


class CudaFused(FusedCausal):
    """The whole strict-causal pipeline in the flow_fused CUDA kernel: one
    CTA per (row, kv head) with the FlowState in shared memory; packed
    prefill masks each row past its length so the final carry is the
    boundary FlowState.  Forward and prefill differentiate through the
    reverse-scan backward kernel K2."""

    differentiable = frozenset({"forward", "prefill"})

    def supports(self, cfg, shapes, platform, *, op="forward"):
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


class Recurrent(Backend):
    """The O(d^2) recurrence one token at a time (plain PyTorch); returns a
    new state."""

    provides = frozenset({"decode"})
    differentiable = frozenset({"forward", "prefill", "decode"})

    def supports(self, cfg, shapes, platform, *, op="forward"):
        why = (_check_decode(cfg, shapes, op)
               or _check_plain(cfg, self.name, platform))
        if why:
            return False, why
        return True, "O(d^2) recurrence"

    def decode_step(self, state, q, k, v, cfg):
        k, v = pipeline.expand_kv(q, k, v, cfg)
        return recurrent.decode_step(state, q, k, v, cfg)


class CudaDecode(Recurrent):
    """One flow_decode CUDA launch advances the whole (slots, Hkv) state
    pool in place: the serving hot loop."""

    differentiable = frozenset()

    def supports(self, cfg, shapes, platform, *, op="forward"):
        why = (_check_decode(cfg, shapes, op)
               or _check_kernel(shapes, platform))
        if why:
            return False, why
        return True, "flow_decode CUDA kernel, state updated in place"

    def decode_step(self, state, q, k, v, cfg):
        from repro_torch.kernels.flow_decode import flow_decode_step

        k, v = pipeline.expand_kv(q, k, v, cfg)
        return flow_decode_step(state, q, k, v, cfg)


register_backend("cuda_nc", CudaNC())
register_backend("nc", NonCausal())
register_backend("cuda_fused", CudaFused())
register_backend("fused_causal", FusedCausal())
register_backend("cuda_decode", CudaDecode())
register_backend("recurrent", Recurrent())
