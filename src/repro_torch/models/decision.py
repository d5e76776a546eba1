"""Decision-Flowformer: the Decision Transformer backbone (D4RL, §4.5).

The counterpart of ``repro/models/decision.py``.  Trajectory tokens
(return-to-go, state, action) are embedded per modality, each plus the
timestep's embedding, interleaved into one causal sequence of N = 3 T
tokens, and run through pre-norm causal blocks (3 layers, d 256, 4 heads
in the paper); the action head reads the state tokens, with tanh.
Parameters are a plain dict with the reference's tree

    {"embed_rtg", "embed_state", "embed_action": {"w"}, "embed_t":
     {"table"}, "blocks": [per-block dicts], "final_norm", "action_head":
     {"w", "b"}}

Attention runs ``causal=True`` through the registry (``flowformer_dt``
sets ``chunk_size=0``): on a GPU every flow forward is K1 and every
backward K2, on their padded routes for N = 3 T and for the Table 7
harness's D = 24; the linear kind's numerator is K5a (K5b in its
backward); softmax is plain PyTorch, as the reference's is plain XLA.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers.attention import attention, attn_init
from repro_torch.layers.embeddings import embed, embedding_init
from repro_torch.layers.ffn import ffn, ffn_init
from repro_torch.layers.linear import dense, dense_init
from repro_torch.layers.norms import apply_norm, norm_init
from repro_torch.utils import resolve_device, tree_map


def init(cfg: ModelConfig, generator: torch.Generator, *, state_dim: int,
         action_dim: int, max_ep_len: int = 1000, device="cuda") -> dict:
    """Random parameters with the reference's shapes and initializer
    families, drawn on the CPU from ``generator`` and moved to ``device``."""
    d = cfg.d_model
    blocks = [{"norm1": norm_init(d, cfg.norm),
               "attn": attn_init(generator, cfg),
               "norm2": norm_init(d, cfg.norm),
               "ffn": ffn_init(generator, d, cfg.d_ff, cfg.act)}
              for _ in range(cfg.n_layers)]
    p = {"embed_rtg": dense_init(generator, 1, d),
         "embed_state": dense_init(generator, state_dim, d),
         "embed_action": dense_init(generator, action_dim, d),
         "embed_t": embedding_init(generator, max_ep_len, d),
         "blocks": blocks,
         "final_norm": norm_init(d, cfg.norm),
         "action_head": dense_init(generator, d, action_dim, bias=True)}
    return tree_map(lambda x: x.to(resolve_device(device)), p)


def forward(params, rtg: torch.Tensor, states: torch.Tensor,
            actions: torch.Tensor, timesteps: torch.Tensor, cfg: ModelConfig,
            *, dtype=torch.bfloat16, plan=None) -> torch.Tensor:
    """rtg: (B, T, 1); states: (B, T, S); actions: (B, T, A); timesteps:
    (B, T) int.  Returns the predicted actions (B, T, A), fp32, read at
    the state tokens.  ``plan``: an ``ExecutionPlan`` or ``BoundExecutor``
    of causal attention."""
    b, t, _ = states.shape
    te = embed(params["embed_t"], timesteps, dtype)  # (B, T, d)
    er = dense(params["embed_rtg"], rtg.to(dtype)) + te
    es = dense(params["embed_state"], states.to(dtype)) + te
    ea = dense(params["embed_action"], actions.to(dtype)) + te
    # interleave (r_t, s_t, a_t)
    x = torch.stack([er, es, ea], dim=2).reshape(b, 3 * t, cfg.d_model)
    for bp in params["blocks"]:
        h = apply_norm(bp["norm1"], x, cfg.norm)
        x = x + attention(bp["attn"], h, cfg, causal=True, plan=plan)
        x = x + ffn(bp["ffn"], apply_norm(bp["norm2"], x, cfg.norm), cfg.act)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    state_tokens = x.reshape(b, t, 3, cfg.d_model)[:, :, 1]
    return torch.tanh(dense(params["action_head"], state_tokens)).float()


def loss_fn(params, batch: dict, cfg: ModelConfig, *, dtype=torch.bfloat16,
            plan=None):
    """batch: {"rtg", "states", "actions_in" (the actions shifted so that
    position t sees a_{t-1}), "actions" (the targets), "timesteps", and
    optionally "mask" (B, T)}.  Returns (masked mean squared error,
    {"loss"})."""
    pred = forward(params, batch["rtg"], batch["states"],
                   batch["actions_in"], batch["timesteps"], cfg, dtype=dtype,
                   plan=plan)
    target = batch["actions"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(target.shape[:2], dtype=torch.float32,
                          device=target.device)
    mse = ((pred - target).square().mean(-1) * mask).sum() \
        / torch.clamp(mask.sum(), min=1.0)
    return mse, {"loss": mse}
