"""Train-step planning for the LM, the counterpart of the parts of
``repro/launch/steps.py`` that one device needs: the attention shapes of
a training step, the build-time check that every layer's mixer and the
attention backend are differentiable, and the microbatch rule of
``RunPlan.choose``.  Meshes, sharding and the serve steps wait for the
distribution slice.
"""
from __future__ import annotations

from repro_torch import attention
from repro_torch.config import ModelConfig, ShapeSpec
from repro_torch.layers.attention import flow_cfg_of, plan_of
from repro_torch.layers.mixer import resolve_mixers


def training_shapes(cfg: ModelConfig, shape: ShapeSpec) -> attention.ShapeInfo:
    """Static attention shapes of one training step (for plan resolution)."""
    d = cfg.dim_head
    return attention.ShapeInfo(b=max(1, shape.global_batch), hq=cfg.n_heads,
                               hkv=cfg.kv_heads, n=shape.seq_len,
                               m=shape.seq_len, d=d, dv=d)


def check_flow_trainable(cfg: ModelConfig, shape: ShapeSpec, platform: str,
                         xplan: attention.ExecutionPlan | None = None):
    """The attention backend a training step will differentiate on
    ``platform``, or None for a stack without attention layers.

    In the reference's order: first every layer's mixer is resolved for
    gradients (``MixerResolutionError`` names a mixer that cannot
    differentiate); then, only where some layer is an attention layer, the
    flow backend is resolved for training, raising ``ResolutionError``
    with every backend's reason when none is differentiable (a
    forward-only pin, for instance).  An attention-free stack (an SSD
    stack) resolves no backend: the reference resolves an unused
    ``xla_cumsum`` there, and the port has no such floor -- on the card no
    kernel takes the attention shape such a config implies.
    """
    xplan = xplan if xplan is not None else plan_of(cfg, needs_grad=True)
    resolve_mixers(cfg, xplan, platform)
    if not any(cfg.block_kind(i) == "attn" for i in range(cfg.n_layers)):
        return None
    if cfg.attention.kind != "flow":
        raise NotImplementedError("only flow attention is ported")
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
