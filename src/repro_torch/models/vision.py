"""The paper's hierarchical vision Flowformer (ImageNet §4.3, Tab. 8).

The counterpart of ``repro/models/vision.py``.  Four stages -- layers
(3, 3, 10, 3), channels (96, 192, 384, 768), 16 heads, so head dims 6, 12,
24 and 48, at sequence lengths (3136, 784, 196, 49) for 224 x 224 inputs.
Patch embedding and the between-stage downsampling are patch-merge linears
without bias (conv equivalents); the blocks are pre-norm (layernorm)
non-causal attention and a gelu FFN of 4 x the stage's width; then a final
norm, a global average pool and a linear classifier with bias.  No rope.
Parameters are a plain dict with the reference's tree

    {"patch_embed": {"w"}, "stages": [{"blocks": [per-block dicts],
     "merge": {"w"} (not in the last stage)}], "final_norm",
     "classifier": {"w", "b"}}

Attention runs ``causal=False`` through the registry with each stage's
head dim (``_stage_cfg``): on a GPU every forward is kernel K6 and every
backward K7b, the small head dims on their CUDA-core route.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.attention import ShapeInfo
from repro_torch.config import ModelConfig
from repro_torch.layers.attention import attention, attn_init
from repro_torch.layers.ffn import ffn, ffn_init
from repro_torch.layers.linear import dense, dense_init
from repro_torch.layers.norms import apply_norm, norm_init
from repro_torch.utils import resolve_device, tree_map


def _stage_cfg(cfg: ModelConfig, ch: int) -> ModelConfig:
    return dataclasses.replace(
        cfg, d_model=ch, n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads,
        head_dim=ch // cfg.n_heads, rope="none", mla=None, moe=None,
    )


def stage_cfgs(cfg: ModelConfig) -> list[ModelConfig]:
    """Each stage's attention config (its width and head dim)."""
    return [_stage_cfg(cfg, ch) for ch in cfg.stage_channels]


def attention_shapes(cfg: ModelConfig, batch: int, size: int, *,
                     patch: int = 4) -> list[ShapeInfo]:
    """The attention call's shapes in each stage for ``batch`` images of
    ``size`` x ``size``: (size / patch)^2 tokens in stage 1, a quarter of
    the previous stage's after each merge."""
    hw, out = size // patch, []
    for scfg in stage_cfgs(cfg):
        out.append(ShapeInfo(b=batch, hq=scfg.n_heads, hkv=scfg.kv_heads,
                             n=hw * hw, m=hw * hw, d=scfg.dim_head,
                             dv=scfg.dim_head))
        hw //= 2
    return out


def init(cfg: ModelConfig, generator: torch.Generator, *, patch: int = 4,
         in_ch: int = 3, device="cuda") -> dict:
    """Random parameters with the reference's shapes and initializer
    families, drawn on the CPU from ``generator`` and moved to ``device``."""
    dev = resolve_device(device)
    chans = cfg.stage_channels
    p: dict = {"patch_embed": dense_init(generator, patch * patch * in_ch,
                                         chans[0])}
    p["stages"] = []
    for si, (n_layers, ch) in enumerate(zip(cfg.stage_layers, chans)):
        scfg = _stage_cfg(cfg, ch)
        stage = {"blocks": [{"norm1": norm_init(ch, cfg.norm),
                             "attn": attn_init(generator, scfg),
                             "norm2": norm_init(ch, cfg.norm),
                             "ffn": ffn_init(generator, ch, 4 * ch, cfg.act)}
                            for _ in range(n_layers)]}
        if si + 1 < len(chans):
            stage["merge"] = dense_init(generator, 4 * ch, chans[si + 1])
        p["stages"].append(stage)
    p["final_norm"] = norm_init(chans[-1], cfg.norm)
    p["classifier"] = dense_init(generator, chans[-1], cfg.n_classes,
                                 bias=True)
    return tree_map(lambda x: x.to(dev), p)


def _patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * c)


def _merge2x2(x: torch.Tensor, hw: int) -> torch.Tensor:
    """(B, hw*hw, C) -> (B, (hw/2)^2, 4C) spatial 2x2 concat."""
    b, n, c = x.shape
    g = x.reshape(b, hw, hw, c)
    g = g.reshape(b, hw // 2, 2, hw // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return g.reshape(b, (hw // 2) ** 2, 4 * c)


def forward(params, images: torch.Tensor, cfg: ModelConfig, *,
            patch: int = 4, dtype=torch.bfloat16, plan=None) -> torch.Tensor:
    """images: (B, H, W, 3) -> logits (B, n_classes) fp32.  ``plan``: an
    ``ExecutionPlan`` or ``BoundExecutor`` of non-causal attention (each
    stage's head dim resolves its own backend)."""
    x = dense(params["patch_embed"], _patchify(images.to(dtype), patch))
    hw = images.shape[1] // patch
    for stage, scfg in zip(params["stages"], stage_cfgs(cfg)):
        for bp in stage["blocks"]:
            h = apply_norm(bp["norm1"], x, cfg.norm)
            x = x + attention(bp["attn"], h, scfg, causal=False, plan=plan)
            x = x + ffn(bp["ffn"], apply_norm(bp["norm2"], x, cfg.norm),
                        cfg.act)
        if "merge" in stage:
            x = dense(stage["merge"], _merge2x2(x, hw))
            hw //= 2
    x = apply_norm(params["final_norm"], x, cfg.norm)
    # the reference's mean of the activation dtype: an fp32 sum, rounded once
    pooled = x.float().mean(dim=1).to(x.dtype)
    return dense(params["classifier"], pooled).float()


def loss_fn(params, batch: dict, cfg: ModelConfig, *, dtype=torch.bfloat16,
            plan=None):
    """batch: {"images" (B, H, W, 3), "labels" (B,) int}.  Returns (mean
    cross-entropy, {"loss", "acc"})."""
    logits = forward(params, batch["images"], cfg, dtype=dtype, plan=plan)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return ce, {"loss": ce, "acc": acc}
