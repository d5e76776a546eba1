"""Execution-strategy registry for Flow-Attention (the port's slice).

The counterpart of ``repro/attention/registry.py``.  A ``Backend`` packages
one execution strategy behind the canonical ops (``forward`` / ``prefill``
/ ``decode_step``) and self-reports its applicability — platform,
causality, shapes, competition flags — in ``supports()``.  ``resolve()``
turns ``FlowConfig.backend`` into a backend deterministically:

* ``backend="auto"`` — the first applicable backend in registration order.
* ``backend="plain"`` — auto, restricted to the plain PyTorch backends (no
  CUDA kernel): the reference path the kernels are held against.
* ``backend=<name>`` — that backend exactly; resolution raises with the
  backend's own reason if it does not apply.  An op the named backend
  does not provide at all (decode for a prefill strategy) falls back to
  auto order, so pinning a prefill strategy never breaks serving.

``needs_grad=True`` also asks the backend to declare the op
differentiable (``Backend.differentiable``), so a training step built on a
forward-only kernel fails at build time with that backend's reason.
``quant="int8"`` (or ``"fp8"``) asks for an op that serves a quantized
state pool (``serving/quant.py::QuantizedPool``) in place: only backends
whose ``quant_capable`` accepts it apply.  ``op="verify"`` (speculative
decoding: score a drafted window from a ``FlowState`` and return every
position's boundary state) asks each backend's ``verify_support``, so a
backend without it is rejected with its own reason.

A failed resolution raises ``ResolutionError`` carrying every candidate's
rejection reason in the message and as structured ``.rejections``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.flow_attention import FlowConfig


@dataclasses.dataclass(frozen=True)
class ShapeInfo:
    """Static call-site shapes a backend inspects in ``supports()``."""

    b: int
    hq: int
    hkv: int
    n: int  # query length
    m: int  # key/value length
    d: int
    dv: int

    @classmethod
    def from_qkv(cls, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> "ShapeInfo":
        """Build the static shape record from q/k/v tensors."""
        return cls(b=q.shape[0], hq=q.shape[1], n=q.shape[2], d=q.shape[3],
                   hkv=k.shape[1], m=k.shape[2], dv=v.shape[3])


class Backend:
    """One Flow-Attention execution strategy.

    Subclasses set ``provides`` and override ``supports`` plus the ops they
    implement.  ``supports`` is a pure function of its arguments, so
    resolution is deterministic.
    """

    name: str = "?"
    #: subset of {"forward", "prefill", "prefill_packed", "decode",
    #: "verify"} (``verify``: score a drafted window in one pass from a
    #: FlowState, returning every position's boundary state)
    provides: frozenset = frozenset({"forward"})
    #: subset of ``provides`` that autograd differentiates: plain PyTorch
    #: code or a ``torch.autograd.Function`` whose backward is a kernel.
    #: Forward-only kernels leave it empty; ``resolve(..., needs_grad=True)``
    #: skips them.
    differentiable: frozenset = frozenset()

    def supports(self, cfg: FlowConfig, shapes: ShapeInfo, platform: str,
                 *, op: str = "forward"):
        """Return (applicable: bool, reason: str)."""
        raise NotImplementedError

    def grad_support(self, op: str = "forward"):
        """(ok, reason): whether autograd flows through ``op``."""
        if op in self.differentiable:
            return True, f"differentiable {op}"
        return False, (f"no backward for {op} (forward-only; differentiable "
                       f"ops: {sorted(self.differentiable) or 'none'})")

    def quant_capable(self, platform: str, dtype: str, op: str = "decode"):
        """(ok, reason): can ``op`` serve a quantized state pool directly?

        A quantized plan (``ExecutionPlan.state_dtype`` of int8 or fp8)
        hands the op a ``QuantizedPool`` instead of a ``FlowState``.  The
        default declines, so resolution rejects with a named reason rather
        than silently dequantizing through an unaware backend.
        """
        return False, (
            f"no quantized-state path for {op} (would silently dequantize "
            f"the {dtype} pool; pick a quant-capable strategy)")

    def verify_support(self, op: str = "verify"):
        """(ok, reason): can the backend score a drafted window?  The
        answer is declarative (``"verify" in provides``); resolution asks
        it as it asks ``grad_support``, so a failed speculative plan
        raises with each backend's own reason."""
        if "verify" in self.provides:
            return True, "carry-in chunked verify"
        return False, ("no verify_step (cannot continue a FlowState over a "
                       "drafted window; speculative decoding needs a "
                       "chunked-scan strategy)")

    def forward(self, q, k, v, cfg: FlowConfig):
        """Full-sequence Flow-Attention -> (B, Hq, N, Dv)."""
        raise NotImplementedError(f"{self.name} does not provide forward")

    def prefill(self, q, k, v, cfg: FlowConfig, *, lengths=None):
        """Consume a prompt -> (per-position outputs, decode FlowState)."""
        raise NotImplementedError(f"{self.name} does not provide prefill")

    def decode_step(self, state, q, k, v, cfg: FlowConfig):
        """Advance one token -> (FlowState, out (B, Hq, 1, Dv))."""
        raise NotImplementedError(f"{self.name} does not provide decode_step")

    def verify_step(self, state, q, k, v, cfg: FlowConfig):
        """Score a drafted window in one pass -> (out, trajectory
        FlowState)."""
        raise NotImplementedError(f"{self.name} does not provide verify_step")


class ResolutionError(ValueError):
    """No backend applied; ``rejections`` is ``((name, reason), ...)``."""

    def __init__(self, message: str, rejections=()):
        """Store the message plus the per-candidate rejections."""
        super().__init__(message)
        self.rejections = tuple(rejections)


_REGISTRY: dict[str, Backend] = {}
_ORDER: list[str] = []


def register_backend(name: str, impl: Backend):
    """Register ``impl`` under ``name``, last in auto order."""
    if name in _REGISTRY:
        raise ValueError(f"backend {name!r} already registered")
    impl.name = name
    _REGISTRY[name] = impl
    _ORDER.append(name)
    return impl


def _candidates(cfg: FlowConfig, op: str) -> list:
    """Candidate backend names, in order, for ``cfg.backend`` and ``op``."""
    sel = cfg.backend
    if sel == "auto":
        return list(_ORDER)
    if sel == "plain":
        return [n for n in _ORDER if not n.startswith("cuda_")]
    if sel not in _REGISTRY:
        raise ValueError(f"unknown FlowConfig.backend {sel!r}; expected "
                         f"'auto', 'plain' or one of {tuple(_ORDER)}")
    if op not in _REGISTRY[sel].provides:
        return list(_ORDER)
    return [sel]


def _judge(be: Backend, cfg: FlowConfig, shapes: ShapeInfo, platform: str,
           op: str, needs_grad: bool, quant: str | None = None):
    """The one triage order of ``resolve`` and ``explain``: provides (a
    backend without ``verify`` answers with its ``verify_support`` reason)
    -> gradients -> quantized-state capability -> supports."""
    if op not in be.provides:
        if op == "verify":
            return be.verify_support(op)
        return False, f"does not provide {op}"
    if op == "verify":
        ok, why = be.verify_support(op)
        if not ok:
            return False, why
    if needs_grad:
        ok, why = be.grad_support(op)
        if not ok:
            return False, why
    if quant is not None:
        ok, why = be.quant_capable(platform, quant, op=op)
        if not ok:
            return False, why
    return be.supports(cfg, shapes, platform, op=op)


def resolve(cfg: FlowConfig, shapes: ShapeInfo, platform: str, *,
            op: str = "forward", needs_grad: bool = False,
            quant: str | None = None) -> Backend:
    """Deterministically pick the backend that runs ``op``; with
    ``needs_grad`` only a backend that differentiates ``op``, with
    ``quant`` only one that serves a ``quant`` state pool."""
    rejections = []
    for name in _candidates(cfg, op):
        ok, why = _judge(_REGISTRY[name], cfg, shapes, platform, op,
                         needs_grad, quant)
        if ok:
            return _REGISTRY[name]
        rejections.append((name, why))
    raise ResolutionError(
        f"no applicable Flow-Attention backend for op={op!r}"
        + (" with gradients" if needs_grad else "")
        + (f" with {quant} state pools" if quant is not None else "")
        + f" on platform={platform!r} with {shapes}:\n  "
        + "\n  ".join(f"{n}: {w}" for n, w in rejections), rejections)


def explain(cfg: FlowConfig, shapes: ShapeInfo, platform: str, *,
            op: str = "forward", needs_grad: bool = False,
            quant: str | None = None) -> list:
    """``[(name, applicable, reason)]`` for every registered backend."""
    _candidates(cfg, op)  # rejects an unknown backend name
    return [(name, *_judge(_REGISTRY[name], cfg, shapes, platform, op,
                           needs_grad, quant))
            for name in _ORDER]
