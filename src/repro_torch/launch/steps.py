"""Train-step planning for the flow LM, the counterpart of the parts of
``repro/launch/steps.py`` that one device needs: the attention shapes of
a training step, the build-time check that its attention backend is
differentiable, and the microbatch rule of ``RunPlan.choose``.  Meshes,
sharding and the serve steps wait for the distribution slice.
"""
from __future__ import annotations

from repro_torch import attention
from repro_torch.config import ModelConfig, ShapeSpec
from repro_torch.layers.attention import flow_cfg_of, plan_of


def training_shapes(cfg: ModelConfig, shape: ShapeSpec) -> attention.ShapeInfo:
    """Static attention shapes of one training step (for plan resolution)."""
    d = cfg.dim_head
    return attention.ShapeInfo(b=max(1, shape.global_batch), hq=cfg.n_heads,
                               hkv=cfg.kv_heads, n=shape.seq_len,
                               m=shape.seq_len, d=d, dv=d)


def check_flow_trainable(cfg: ModelConfig, shape: ShapeSpec, platform: str,
                         xplan: attention.ExecutionPlan | None = None):
    """The attention backend a training step will differentiate on
    ``platform``; raises ``ResolutionError`` with every backend's reason
    when none is differentiable (a forward-only pin, for instance)."""
    if cfg.attention.kind != "flow":
        raise NotImplementedError("only flow attention is ported")
    xplan = xplan if xplan is not None else plan_of(cfg, needs_grad=True)
    plan = attention.ExecutionPlan(flow=flow_cfg_of(cfg, causal=True),
                                   packed=xplan.packed,
                                   needs_grad=xplan.needs_grad)
    return attention.resolve_for_training(plan, training_shapes(cfg, shape),
                                          platform)


def microbatch_for(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """``RunPlan.choose``'s microbatch on one device: halve the batch until
    a microbatch holds at most 131,072 tokens (32,768 above 5e10
    parameters); 0 when the whole batch fits."""
    batch = max(1, shape.global_batch)
    budget = 32768 if cfg.param_count() > 5e10 else 131072
    while batch * shape.seq_len > budget and batch > 1:
        batch //= 2
    return 0 if batch >= shape.global_batch else batch
