"""Step planning, the counterpart of the parts of ``repro/launch/steps.py``
that one device needs: the attention shapes of a training step, the
build-time check that every layer's mixer and the attention backend are
differentiable, the microbatch rule of ``RunPlan.choose``, and the
encoder-decoder's steps (``model_loss_fn``, ``prefill_step``,
``decode_step``) as plain functions of (params, batch).  The LM's loss
and serve steps are ``models/lm.py``'s own; meshes and sharding wait for
the distribution slice.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import attention
from repro_torch.config import ModelConfig, ShapeSpec
from repro_torch.layers.attention import flow_cfg_of, plan_of
from repro_torch.layers.mixer import resolve_mixers


def _encdec(cfg: ModelConfig):
    """``models.encdec``, after checking that ``cfg`` is an
    encoder-decoder."""
    from repro_torch.models import encdec

    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: the step builders here serve the "
                         f"encoder-decoder, not family {cfg.family!r}")
    return encdec


def model_loss_fn(cfg: ModelConfig, *, dtype=torch.bfloat16, plan=None):
    """``loss_fn(params, batch)`` of the encoder-decoder in ``dtype``, its
    attention bound once from ``plan``."""
    encdec = _encdec(cfg)
    return functools.partial(encdec.loss_fn, cfg=cfg, dtype=dtype,
                             plan=encdec.executors(cfg, plan))


def training_shapes(cfg: ModelConfig, shape: ShapeSpec) -> attention.ShapeInfo:
    """Static attention shapes of one training step (for plan resolution):
    with MLA, q and k nope + rope wide and v its own width, one kv head a
    query head."""
    if cfg.mla is not None:
        d = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
        dv, hq, hkv = cfg.mla.v_head_dim, cfg.n_heads, cfg.n_heads
    else:
        d = dv = cfg.dim_head
        hq, hkv = cfg.n_heads, cfg.kv_heads
    return attention.ShapeInfo(b=max(1, shape.global_batch), hq=hq, hkv=hkv,
                               n=shape.seq_len, m=shape.seq_len, d=d, dv=dv)


def check_flow_trainable(cfg: ModelConfig, shape: ShapeSpec, platform: str,
                         xplan: attention.ExecutionPlan | None = None):
    """The flow attention backend a training step will differentiate on
    ``platform``, or None for a stack without attention layers and for the
    softmax and linear branches, which resolve no flow backend (as in the
    reference): softmax attention is plain PyTorch, and the linear
    branch's causal dot runs K5a and K5b on a CUDA tensor
    (``layers.attention._linear_kernel``).

    In the reference's order: first every layer's mixer is resolved for
    gradients (``MixerResolutionError`` names a mixer that cannot
    differentiate); then, only where some layer is an attention layer, the
    flow backend is resolved for training, raising ``ResolutionError``
    with every backend's reason when none is differentiable (a
    forward-only pin, for instance).  A hybrid stack's "local" slots are
    attention layers in flow mode; in softmax mode they are local rings,
    differentiated in plain PyTorch.  An attention-free stack (an SSD
    stack) resolves no backend: the reference resolves an unused
    ``xla_cumsum`` there, and the port has no such floor -- on the card no
    kernel takes the attention shape such a config implies.
    """
    xplan = xplan if xplan is not None else plan_of(cfg, needs_grad=True)
    resolve_mixers(cfg, xplan, platform)
    kinds = {cfg.block_kind(i) for i in range(cfg.n_layers)}
    # a hybrid stack's "local" slots are flow attention in flow mode only
    if "attn" not in kinds and not ("local" in kinds
                                    and cfg.attention.kind == "flow"):
        return None
    if cfg.attention.kind != "flow":
        return None

    def resolve(causal):
        plan = attention.ExecutionPlan(flow=flow_cfg_of(cfg, causal=causal),
                                       packed=xplan.packed,
                                       needs_grad=xplan.needs_grad)
        return attention.resolve_for_training(
            plan, training_shapes(cfg, shape), platform)

    be = resolve(True)
    if cfg.family == "encdec":  # the encoder side trains non-causally too
        resolve(False)
    return be


def microbatch_for(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """``RunPlan.choose``'s microbatch on one device: halve the batch until
    a microbatch holds at most 131,072 tokens (32,768 above 5e10
    parameters); 0 when the whole batch fits."""
    batch = max(1, shape.global_batch)
    budget = 32768 if cfg.param_count() > 5e10 else 131072
    while batch * shape.seq_len > budget and batch > 1:
        batch //= 2
    return 0 if batch >= shape.global_batch else batch


def prefill_step(cfg: ModelConfig, *, dtype=torch.bfloat16, plan=None):
    """The serve step that consumes the inputs: ``encdec.encode`` of
    ``batch["frames"]``, which returns the memory."""
    encdec = _encdec(cfg)
    ex = encdec.executors(cfg, plan)

    def step(params, batch):
        return encdec.encode(params, batch["frames"], cfg, dtype=dtype,
                             plan=ex)
    return step


def decode_step(cfg: ModelConfig, *, dtype=torch.bfloat16, plan=None):
    """The one-token serve step: ``encdec.decode_step`` of
    ``batch["token"]`` on ``batch["memory"]``, ``batch["caches"]`` and
    ``batch["pos"]``, returning (logits, caches)."""
    encdec = _encdec(cfg)
    ex = encdec.executors(cfg, plan)

    def step(params, batch):
        return encdec.decode_step(params, batch["token"], batch["memory"],
                                  batch["caches"], cfg, batch["pos"],
                                  dtype=dtype, plan=ex)
    return step
