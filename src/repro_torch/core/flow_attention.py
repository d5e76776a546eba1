"""Flow-Attention (Wu et al., ICML 2022): configuration and shared maps.

The counterpart of ``repro/core/flow_attention.py``.  Shapes follow the
(batch, heads, length, dim) convention.  ``FlowConfig`` carries the same
fields and defaults as the reference; how the math executes is chosen by
the backend registry in ``repro_torch.attention`` from
``FlowConfig.backend`` (``"auto"`` or a registered backend name).

GQA in ``gqa_mode="shared"``: the G query heads of a kv head act as one
population of sinks, so flows and the decode state live per kv head.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch
import torch.nn.functional as F

PhiKind = Literal["sigmoid", "elu1", "relu"]


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    eps: float = 1e-6
    phi: PhiKind = "sigmoid"
    causal: bool = False
    strict_causal: bool = False
    gqa_mode: Literal["shared", "expand"] = "shared"
    # ablations (paper Tab. 2 rows / Tab. 11): disable either mechanism
    use_competition: bool = True
    use_allocation: bool = True
    # chunk size for the chunked/fused causal strategies
    chunk_size: int = 128
    # execution strategy: "auto" resolves over the repro_torch.attention
    # registry (CUDA kernels on a GPU, plain PyTorch elsewhere); "plain"
    # restricts it to the plain PyTorch backends; any registered backend
    # name pins it.
    backend: str = "auto"


def phi_map(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "elu1":
        return F.elu(x) + 1.0
    if kind == "relu":
        return torch.relu(x)
    raise ValueError(f"unknown phi {kind!r}")


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, Hq, N, D) -> (B, Hkv, G, N, D)."""
    b, hq, n, d = q.shape
    if hq % n_kv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {n_kv}")
    return q.reshape(b, n_kv, hq // n_kv, n, d)


def _ungroup(x: torch.Tensor) -> torch.Tensor:
    b, hkv, g, n, d = x.shape
    return x.reshape(b, hkv * g, n, d)


def flow_attention_nc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg: FlowConfig = FlowConfig()) -> torch.Tensor:
    """Non-causal Flow-Attention through the backend registry.

    q: (B, Hq, N, D); k: (B, Hkv, M, D); v: (B, Hkv, M, Dv) with Hkv | Hq.
    Returns (B, Hq, N, Dv).  On a GPU ``auto`` runs the flow_nc CUDA
    kernel; the plain version runs on the CPU or when pinned.
    """
    from repro_torch import attention  # lazy: the registry imports this module

    if cfg.causal:
        cfg = dataclasses.replace(cfg, causal=False)
    return attention.resolve(attention.ExecutionPlan(flow=cfg)).forward(q, k, v)


def flow_attention_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cfg: FlowConfig = FlowConfig(causal=True), *,
                          return_state: bool = False):
    """Causal Flow-Attention (self-attention: N == M) through the registry.

    q: (B, Hq, N, D); k: (B, Hkv, N, D); v: (B, Hkv, N, Dv).  Returns
    (B, Hq, N, Dv); with ``return_state=True`` (requires strict causal
    competition) also the O(d^2) ``FlowState`` that decoding continues
    from.
    """
    from repro_torch import attention  # lazy: the registry imports this module

    if not cfg.causal:
        cfg = dataclasses.replace(cfg, causal=True)
    ex = attention.resolve(attention.ExecutionPlan(flow=cfg))
    if return_state:
        if not (cfg.strict_causal and cfg.use_competition):
            raise ValueError("recurrent decode state requires strict_causal "
                             "competition")
        return ex.prefill(q, k, v)
    return ex.forward(q, k, v)


def flow_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: FlowConfig) -> torch.Tensor:
    """Flow-Attention in the mode ``cfg`` names, through the registry."""
    from repro_torch import attention  # lazy: the registry imports this module

    return attention.resolve(attention.ExecutionPlan(flow=cfg)).forward(q, k, v)
