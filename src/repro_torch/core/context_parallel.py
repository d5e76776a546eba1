"""DEPRECATED shim: context parallelism lives in the backend registry.

The counterpart of ``repro/core/context_parallel.py``.  The shard-local
math is the ``cp_nc`` / ``cp_causal`` backends of ``attention/cp.py``
(psums for non-causal, the exclusive-prefix scan for causal), resolved
like every other execution strategy.  Build a sharded ``ExecutionPlan``
instead::

    from repro_torch import attention

    plan = attention.ExecutionPlan(
        flow=cfg, shard=attention.ShardSpec(axis="model", mesh=mesh))
    out = attention.resolve(plan).forward(q, k, v)

``make_context_parallel`` is kept for old callers: it builds exactly that
plan and warns once.
"""
from __future__ import annotations

import warnings

from repro_torch.core.flow_attention import FlowConfig

_WARNED = False


def make_context_parallel(mesh, cfg: FlowConfig, *, seq_axis: str = "model"):
    """Deprecated: a sequence-parallel flow attention over ``mesh`` (a
    ``distribution.mesh.Mesh``); inputs and outputs are (B, H, N, D) with N
    split over ``seq_axis``."""
    global _WARNED
    if not _WARNED:
        _WARNED = True
        warnings.warn(
            "make_context_parallel is deprecated: build a sharded "
            "attention.ExecutionPlan(flow=cfg, shard=ShardSpec(axis=..., "
            "mesh=...)) and call attention.resolve(plan).forward(...)",
            DeprecationWarning, stacklevel=2)
    from repro_torch import attention

    ex = attention.resolve(attention.ExecutionPlan(
        flow=cfg, shard=attention.ShardSpec(axis=seq_axis, mesh=mesh)))

    def wrapped(q, k, v):
        return ex.forward(q, k, v)

    return wrapped
