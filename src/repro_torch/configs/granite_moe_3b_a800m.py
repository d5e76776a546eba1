"""Granite-MoE 3B-A800M [hf:ibm-granite]: 32L, d_model 1536, 24 heads (GQA
kv=8), expert d_ff 512, vocab 49155, MoE 40 experts top-8, SwiGLU.

Assignment-sheet conflict: "MoE 40e top-8" vs trailing "32 experts top-8";
we implement 40 experts (primary spec) — DESIGN.md §5."""
import dataclasses

from repro_torch.config import AttentionConfig, MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="lm",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        max_seq_len=4096,
        act="swiglu",
        norm="rmsnorm",
        rope="rope",
        attention=AttentionConfig(kind="flow"),
        moe=MoEConfig(n_experts=40, n_shared=0, top_k=8, d_ff_expert=512,
                      capacity_factor=1.25),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=64, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(kind="flow", chunk_size=32),
        moe=MoEConfig(n_experts=8, n_shared=0, top_k=2, d_ff_expert=64,
                      capacity_factor=2.0),
    )
