"""Encoder classifier: the LRA (§4.1) and UEA time-series (§4.4) model.

The counterpart of ``repro/models/classifier.py``.  Token or continuous
inputs -> non-causal encoder blocks (``norm1 -> attention -> residual ->
norm2 -> FFN -> residual``) -> final norm -> mean pool (over ``mask``
where given) -> linear head with bias.  Parameters are a plain dict

    {"embed": {"table"} or "in_proj": {"w"}, "blocks": [per-layer dicts],
     "final_norm", "head": {"w", "b"}}

with the blocks always a list (the reference's classifier never stacks its
layers).  Attention runs ``causal=False`` through the registry: on a GPU
every forward is kernel K6 and every backward K7b.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers.attention import attention, attn_init
from repro_torch.layers.embeddings import embed, embedding_init
from repro_torch.layers.ffn import ffn, ffn_init
from repro_torch.layers.linear import dense, dense_init
from repro_torch.layers.norms import apply_norm, norm_init
from repro_torch.layers.rope import default_positions
from repro_torch.utils import resolve_device, tree_map


def init(cfg: ModelConfig, generator: torch.Generator, *, n_classes: int,
         in_dim: int = 0, device="cuda") -> dict:
    """Random parameters with the reference's shapes and initializer
    families, drawn on the CPU from ``generator`` and moved to ``device``.
    ``in_dim > 0``: continuous inputs (time series); else token inputs."""
    dev = resolve_device(device)
    d = cfg.d_model
    p: dict = {}
    if in_dim:
        p["in_proj"] = dense_init(generator, in_dim, d)
    else:
        p["embed"] = embedding_init(generator, cfg.vocab_size, d)
    p["blocks"] = [{"norm1": norm_init(d, cfg.norm),
                    "attn": attn_init(generator, cfg),
                    "norm2": norm_init(d, cfg.norm),
                    "ffn": ffn_init(generator, d, cfg.d_ff, cfg.act)}
                   for _ in range(cfg.n_layers)]
    p["final_norm"] = norm_init(d, cfg.norm)
    p["head"] = dense_init(generator, d, n_classes, bias=True)
    return tree_map(lambda x: x.to(dev), p)


def forward(params, inputs: torch.Tensor, cfg: ModelConfig, *,
            mask: torch.Tensor | None = None, dtype=torch.bfloat16,
            plan=None) -> torch.Tensor:
    """inputs: int tokens (B, N) or features (B, N, in_dim); mask (B, N)
    weights the mean pool.  Returns logits (B, n_classes) fp32."""
    b, n = inputs.shape[0], inputs.shape[1]
    if "in_proj" in params:
        x = dense(params["in_proj"], inputs.to(dtype))
    else:
        x = embed(params["embed"], inputs, dtype)
    positions = default_positions(b, n, device=inputs.device)
    for bp in params["blocks"]:
        h = apply_norm(bp["norm1"], x, cfg.norm)
        x = x + attention(bp["attn"], h, cfg, causal=False,
                          positions=positions, plan=plan)
        x = x + ffn(bp["ffn"], apply_norm(bp["norm2"], x, cfg.norm), cfg.act)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if mask is not None:
        w = mask.float()[..., None]
        pooled = (x.float() * w).sum(1) / w.sum(1).clamp(min=1.0)
    else:
        pooled = x.float().mean(dim=1)
    return dense(params["head"], pooled.to(dtype)).float()


def loss_fn(params, batch: dict, cfg: ModelConfig, *, dtype=torch.bfloat16,
            plan=None):
    """batch: {"inputs", "labels" (B,) int, "mask" (B, N) optional}.
    Returns (mean cross-entropy, {"loss", "acc"})."""
    logits = forward(params, batch["inputs"], cfg, mask=batch.get("mask"),
                     dtype=dtype, plan=plan)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return ce, {"loss": ce, "acc": acc}
