"""Attention layer, flow branch (the paper's mechanism).

The counterpart of the flow branch of ``repro/layers/attention.py``.  Modes:

  * full     — whole sequence, no cache (``attention``);
  * prefill  — whole prompt, returns the decode state; with ``lengths`` a
               right-padded batch of prompts with per-row boundary states;
  * decode   — one token on the O(d^2) ``FlowState``, or on a
               ``QuantizedPool`` of one when the plan's ``state_dtype`` is
               int8 (the pool passes to the executor unchanged).

Which kernel or scan realizes the math is resolved by the
``repro_torch.attention`` registry from the ``ExecutionPlan`` built once
(``plan_of``); this layer never names an execution path.  A caller that
runs many steps binds the plan once (``executor_of``) and passes the
``BoundExecutor`` as ``plan``, so no step re-resolves a backend.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.attention import BoundExecutor, ExecutionPlan, init_state
from repro_torch.config import ModelConfig
from repro_torch.core.flow_attention import FlowConfig
from repro_torch.layers import mixer as mixer_lib
from repro_torch.layers.linear import dense, dense_init
from repro_torch.layers.rope import apply_rope
from repro_torch.serving import quant as quant_lib
from repro_torch.utils import resolve_device


def _require_flow(cfg: ModelConfig):
    if cfg.attention.kind != "flow" or cfg.mla is not None:
        raise NotImplementedError(
            f"attention kind {cfg.attention.kind!r}"
            + (" with MLA" if cfg.mla is not None else "")
            + " is not ported yet (flow attention only)")


def flow_cfg_of(cfg: ModelConfig, causal: bool) -> FlowConfig:
    a = cfg.attention
    return FlowConfig(
        phi=a.phi,
        causal=causal,
        strict_causal=a.strict_causal,
        use_competition=a.use_competition,
        use_allocation=a.use_allocation,
        chunk_size=a.chunk_size,
        gqa_mode=a.gqa_mode,
        backend=a.backend,
    )


def plan_of(cfg: ModelConfig, *, causal: bool = True, packed: bool = False,
            needs_grad: bool = False,
            state_dtype: str | None = None) -> ExecutionPlan:
    """Build the model-level ``ExecutionPlan`` once; ``flow`` comes from
    ``cfg.attention``; ``needs_grad`` for a training step; ``state_dtype``
    the serving state pools' dtype (None, "bf16" and "fp32" keep the fp32
    FlowState, "int8" and "fp8" quantize every pool)."""
    return ExecutionPlan(flow=flow_cfg_of(cfg, causal), packed=packed,
                         needs_grad=needs_grad, state_dtype=state_dtype)


def executor_of(cfg: ModelConfig, plan: ExecutionPlan | None = None, *,
                causal: bool = True) -> BoundExecutor:
    """Bind ``plan`` (default ``plan_of(cfg)``) with ``flow`` from
    ``cfg.attention``, once."""
    fc = flow_cfg_of(cfg, causal)
    return BoundExecutor(ExecutionPlan(flow=fc) if plan is None
                         else dataclasses.replace(plan, flow=fc))


def _flow_executor(cfg: ModelConfig, causal: bool,
                   plan: ExecutionPlan | BoundExecutor | None) -> BoundExecutor:
    if isinstance(plan, BoundExecutor):
        return plan
    return executor_of(cfg, plan, causal=causal)


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    _require_flow(cfg)
    d, hd = cfg.d_model, cfg.dim_head
    nq, nkv = cfg.n_heads, cfg.kv_heads
    return {
        "wq": dense_init(gen, d, nq * hd),
        "wk": dense_init(gen, d, nkv * hd),
        "wv": dense_init(gen, d, nkv * hd),
        "wo": dense_init(gen, nq * hd, d),
    }


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, n, _ = x.shape
    return x.reshape(b, n, n_heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _apply_positions(q, k, cfg: ModelConfig, positions):
    if positions is None or cfg.rope in ("none", "learned"):
        return q, k
    if cfg.rope == "rope":
        return (apply_rope(q, positions, theta=cfg.rope_theta),
                apply_rope(k, positions, theta=cfg.rope_theta))
    raise NotImplementedError(f"rope={cfg.rope!r} is not ported yet")


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig, positions):
    """Per-head q, k, v with positional encoding applied."""
    q = _split_heads(dense(params["wq"], x), cfg.n_heads)
    k = _split_heads(dense(params["wk"], x), cfg.kv_heads)
    v = _split_heads(dense(params["wv"], x), cfg.kv_heads)
    q, k = _apply_positions(q, k, cfg, positions)
    return q, k, v


def attention(params, x: torch.Tensor, cfg: ModelConfig, *, causal: bool,
              positions=None, plan: ExecutionPlan | BoundExecutor | None = None):
    """Full-sequence attention.  x: (B, N, d_model)."""
    _require_flow(cfg)
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _flow_executor(cfg, causal, plan).forward(q, k, v)
    return dense(params["wo"], _merge_heads(out))


def _attn_cache_init(cfg: ModelConfig, batch: int, device="cuda"):
    """Decode state for one flow layer: the O(d^2) FlowState, fp32, on
    ``device`` (the card unless the caller asks for the CPU)."""
    _require_flow(cfg)
    return init_state(batch, cfg.kv_heads, cfg.dim_head, cfg.dim_head,
                      device=resolve_device(device))


def _attention_prefill(params, x: torch.Tensor, cfg: ModelConfig, *,
                       positions=None, lengths=None,
                       plan: ExecutionPlan | BoundExecutor | None = None):
    """Prompt prefill returning (out, FlowState).  ``lengths`` (B,) serves
    a right-padded batch of prompts: each row's state lands at its own
    boundary; outputs at padded positions are never read."""
    _require_flow(cfg)
    q, k, v = _project_qkv(params, x, cfg, positions)
    out, state = _flow_executor(cfg, True, plan).prefill(q, k, v,
                                                         lengths=lengths)
    return dense(params["wo"], _merge_heads(out)), state


def _attention_decode(params, x: torch.Tensor, cache, cfg: ModelConfig, *,
                      positions=None,
                      plan: ExecutionPlan | BoundExecutor | None = None):
    """One-token decode.  x: (B, 1, d_model) -> (out, new_state)."""
    _require_flow(cfg)
    q, k, v = _project_qkv(params, x, cfg, positions)
    new_state, out = _flow_executor(cfg, True, plan).decode_step(cache, q, k, v)
    return dense(params["wo"], _merge_heads(out)), new_state


class AttentionMixer(mixer_lib.Mixer):
    """The attention layer ("attn" pattern slots) as a sequence mixer."""

    params_field = "attn"

    def quant_capable(self, cfg, platform, dtype):
        ok, why = quant_lib.platform_support(dtype, platform)
        if not ok:
            return False, why
        return True, f"quantized FlowState pool ({why})"

    def init_params(self, gen, cfg):
        return attn_init(gen, cfg)

    def forward(self, params, x, cfg, *, positions=None, plan=None):
        return attention(params, x, cfg, causal=True, positions=positions,
                         plan=plan)

    def state_init(self, cfg, batch, max_len, *, device="cuda", plan=None):
        # a flow state stays fp32 under a bf16/fp32 state_dtype; int8/fp8
        # wrap it in a QuantizedPool
        return quant_lib.maybe_quantize(
            _attn_cache_init(cfg, batch, device=device), plan)

    def prefill(self, params, x, cfg, max_len, *, positions=None,
                lengths=None, plan=None):
        return _attention_prefill(params, x, cfg, positions=positions,
                                  lengths=lengths, plan=plan)

    def decode_step(self, params, x, state, cfg, *, positions=None,
                    plan=None):
        return _attention_decode(params, x, state, cfg, positions=positions,
                                 plan=plan)


mixer_lib.register_mixer("attn", AttentionMixer())
