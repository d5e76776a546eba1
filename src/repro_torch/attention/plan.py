"""ExecutionPlan: the execution context bound once, not threaded per call.

The counterpart of ``repro/attention/plan.py``, reduced to this slice:
``flow`` (the ``FlowConfig``), ``packed`` (the plan serves right-padded
multi-prompt prefill), ``paged`` (a ``serving.paged.PagedSpec``: softmax
KV caches live in a page pool), ``needs_grad`` (a training step will
differentiate through every op, so only differentiable backends apply),
``speculate_k`` (drafted tokens a speculative verify window scores: mixer
resolution demands ``verify_capable`` and the registry triages the
``verify`` op) and ``state_dtype`` (the serving state pools' dtype: int8
or fp8 pools make ``decode`` and ``verify`` resolve only to backends that
are ``quant_capable``).
The platform is the device of the tensors each op is given.
``resolve(plan)`` returns a ``BoundExecutor`` whose ops resolve through
the registry once per call signature (op, shapes, device) and reuse that
backend afterwards; ``explain(plan, shapes, platform=)`` reports every
backend's verdict per op with its reason.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.attention import registry
from repro_torch.attention.registry import Backend, ShapeInfo
from repro_torch.core.flow_attention import FlowConfig
from repro_torch.serving.quant import QUANT_DTYPES, STATE_DTYPES

_STATE_OPS = ("prefill", "prefill_packed", "decode", "verify")


def _quant_of(plan, op: str) -> str | None:
    """The quantized state dtype ``op`` must serve, or None.

    Only the state-consuming ops (decode, verify) see the pool: forward and
    prefill run on activations and produce full-precision boundary states
    that are quantized at install.  bf16 and fp32 state dtypes are storage
    choices, not quantization, and never reach the registry.
    """
    sd = plan.state_dtype
    return sd if (sd in QUANT_DTYPES and op in ("decode", "verify")) else None


def _op_cfg(cfg: FlowConfig, op: str) -> FlowConfig:
    if op in _STATE_OPS:
        return dataclasses.replace(cfg, causal=True, strict_causal=True)
    return cfg


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Static execution context for Flow-Attention."""

    flow: FlowConfig | None = None
    packed: bool = False
    #: a ``serving.paged.PagedSpec`` for softmax baseline caches; layers
    #: that cannot page (``Mixer.paged_capable``) have it stripped
    paged: Any = None
    needs_grad: bool = False
    #: speculative decoding: drafted tokens scored per verify window (0 =
    #: plain decode); mixer resolution then demands ``verify_capable`` and
    #: ``explain`` triages the ``verify`` op
    speculate_k: int = 0
    #: serving state-pool dtype, distinct from the activation dtype: None,
    #: "bf16" or "fp32" keep the fp32 FlowState (and set the softmax KV
    #: caches' storage dtype); "int8" or "fp8" wrap every
    #: pool in a ``serving.quant.QuantizedPool`` and make decode resolution
    #: demand ``quant_capable`` from backends and mixers
    state_dtype: str | None = None

    def __post_init__(self):
        if self.state_dtype is not None and \
                self.state_dtype not in STATE_DTYPES:
            raise ValueError(f"unknown state_dtype {self.state_dtype!r}; "
                             f"expected one of {STATE_DTYPES}")

    def describe(self) -> str:
        """One-line summary of the plan's non-default fields."""
        bits = [f"backend={self.flow.backend!r}" if self.flow else "flow=?"]
        if self.packed:
            bits.append("packed")
        if self.paged is not None:
            bits.append(f"paged[{getattr(self.paged, 'page_size', '?')}]")
        if self.needs_grad:
            bits.append("needs_grad")
        if self.speculate_k:
            bits.append(f"speculate_k={self.speculate_k}")
        if self.state_dtype:
            bits.append(f"state_dtype={self.state_dtype}")
        return "ExecutionPlan(" + ", ".join(bits) + ")"


class BoundExecutor:
    """The canonical ops bound to one ``ExecutionPlan``.

    Each op resolves its backend on the first call with a given (shapes,
    device) and reuses it on every later call with the same ones, so a
    serving loop that binds its executor once chooses no backend per step.
    """

    def __init__(self, plan: ExecutionPlan):
        """Bind ``plan`` (its ``flow`` must be set) for per-op resolution."""
        if plan.flow is None:
            raise ValueError("ExecutionPlan.flow is unset")
        self.plan = plan
        self._cfgs = {op: _op_cfg(plan.flow, op)
                      for op in ("forward",) + _STATE_OPS}
        self._bound: dict = {}

    def backend(self, op: str, shapes: ShapeInfo, platform: str) -> Backend:
        """Resolve and return the backend the plan binds for ``op``."""
        return registry.resolve(self._cfgs[op], shapes, platform, op=op,
                                needs_grad=self.plan.needs_grad,
                                quant=_quant_of(self.plan, op))

    def _bind(self, op, q, k, v):
        key = (op, q.shape, k.shape, v.shape, q.device.type,
               _quant_of(self.plan, op))
        hit = self._bound.get(key)
        if hit is None:
            be = self.backend(op, ShapeInfo.from_qkv(q, k, v), q.device.type)
            hit = self._bound[key] = (be, self._cfgs[op])
        return hit

    def forward(self, q, k, v):
        """Full-sequence Flow-Attention: (B,Hq,N,D) -> (B,Hq,N,Dv)."""
        be, cfg = self._bind("forward", q, k, v)
        return be.forward(q, k, v, cfg)

    def prefill(self, q, k, v, *, lengths=None):
        """Consume a prompt; return (per-position outputs, decode FlowState).

        ``lengths`` (B,) serves a right-padded batch of prompts in one call
        (the ``prefill_packed`` op).
        """
        op = "prefill" if lengths is None else "prefill_packed"
        be, cfg = self._bind(op, q, k, v)
        return be.prefill(q, k, v, cfg, lengths=lengths)

    def decode_step(self, state, q, k, v):
        """Advance one token on the O(d^2) recurrent state (a FlowState,
        or a ``QuantizedPool`` of one when the plan's state_dtype is int8
        or fp8)."""
        be, cfg = self._bind("decode", q, k, v)
        return be.decode_step(state, q, k, v, cfg)

    def verify_step(self, state, q, k, v):
        """Score a drafted window of n tokens from ``state`` in one pass.

        q/k/v carry ``n = k_draft + 1`` positions continuing each row at
        ``state.t`` (a FlowState, or a ``QuantizedPool`` of one).  Returns
        ``(out, traj)``: ``out`` (B, Hq, n, Dv) matches what n sequential
        ``decode_step`` calls would emit, and ``traj`` is a trajectory
        ``FlowState`` (window axis at index 1) whose accepted boundary
        ``recurrent.select_state`` gathers.
        """
        be, cfg = self._bind("verify", q, k, v)
        return be.verify_step(state, q, k, v, cfg)


def resolve_plan(plan: ExecutionPlan) -> BoundExecutor:
    """Bind an ``ExecutionPlan`` to an executor."""
    return BoundExecutor(plan)


def resolve_for_training(plan: ExecutionPlan, shapes: ShapeInfo,
                         platform: str) -> Backend:
    """The forward backend autograd will differentiate, ``needs_grad``
    forced on: a training step calls this when it is built, so a
    forward-only pin raises there with every backend's reason."""
    plan = dataclasses.replace(plan, needs_grad=True)
    return BoundExecutor(plan).backend("forward", shapes, platform)


@dataclasses.dataclass(frozen=True)
class PlanExplanation:
    """Per-op resolution triage: ``sections`` is
    ``((op, ((name, applicable, reason), ...)), ...)``."""

    plan: ExecutionPlan
    platform: str
    sections: tuple

    def __str__(self) -> str:
        """Render the triage: plan header, then per-op OK/no rows."""
        lines = [f"{self.plan.describe()} on {self.platform!r}"]
        for op, rows in self.sections:
            lines.append(f" op={op!r}:")
            lines.extend(f"  {'OK ' if ok else 'no '} {name}: {why}"
                         for name, ok, why in rows)
        return "\n".join(lines)


def explain_plan(plan: ExecutionPlan, shapes: ShapeInfo, *, platform: str,
                 op: str | None = None) -> PlanExplanation:
    """Every backend's verdict with its reason on ``platform`` ("cuda" or
    "cpu") at ``shapes``, for ``op`` or for every op the plan implies
    (forward, prefill, prefill_packed if packed, decode, verify if
    speculative)."""
    if plan.flow is None:
        raise ValueError("explain(plan) needs plan.flow")
    if op is None:
        ops = (["forward", "prefill"]
               + (["prefill_packed"] if plan.packed else []) + ["decode"]
               + (["verify"] if plan.speculate_k else []))
    else:
        ops = [op]
    sections = tuple(
        (one, tuple(registry.explain(_op_cfg(plan.flow, one), shapes,
                                     platform, op=one,
                                     needs_grad=plan.needs_grad,
                                     quant=_quant_of(plan, one))))
        for one in ops)
    return PlanExplanation(plan=plan, platform=platform, sections=sections)
