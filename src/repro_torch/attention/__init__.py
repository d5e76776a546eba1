"""Pluggable Flow-Attention execution for the port.

Call sites build one ``ExecutionPlan`` and use the canonical ops through
the bound executor, never naming an execution path::

    from repro_torch import attention

    ex = attention.resolve(attention.ExecutionPlan(flow=cfg))
    out = ex.forward(q, k, v)
    out, state = ex.prefill(q, k, v, lengths=lengths)
    state, out = ex.decode_step(state, q, k, v)

``FlowConfig.backend="auto"`` resolves to the CUDA kernels on a GPU
(``cuda_nc`` for non-causal plans; ``cuda_fused``, ``cuda_decode`` for
strict-causal ones; ``cuda_chunk`` for the paper-faithful causal mode
and the no-competition ablation), and raises there for a shape or mode
no kernel takes, and to their plain PyTorch versions on the CPU (``nc``,
``fused_causal``, ``chunked`` or ``cumsum``, ``recurrent``); ``"plain"``
keeps to the plain versions on any device; a registered name pins one.  ``explain(plan, shapes, platform=)`` names
each backend's verdict and reason.  ``ExecutionPlan(needs_grad=True)``
(or ``resolve_for_training``) admits only backends that differentiate the
op: on a GPU a strict-causal forward then runs K1 and its backward K2,
a paper-causal one K5a and its backward K5a and K5b, a non-causal one K6
and its backward K7b.
"""
from repro_torch.attention.plan import (
    BoundExecutor,
    ExecutionPlan,
    PlanExplanation,
)
from repro_torch.attention.plan import explain_plan as explain
from repro_torch.attention.plan import resolve_for_training
from repro_torch.attention.plan import resolve_plan as resolve
from repro_torch.attention.recurrent import FlowState, init_state
from repro_torch.attention.registry import (
    Backend,
    ResolutionError,
    ShapeInfo,
    register_backend,
)
from repro_torch.attention import backends as _backends  # registers the builtins
from repro_torch.core.flow_attention import FlowConfig

__all__ = [
    "Backend",
    "BoundExecutor",
    "ExecutionPlan",
    "FlowConfig",
    "FlowState",
    "PlanExplanation",
    "ResolutionError",
    "ShapeInfo",
    "explain",
    "init_state",
    "register_backend",
    "resolve",
    "resolve_for_training",
]
