"""Granite-8B code model [arXiv:2405.04324]: 36L, d_model 4096, 32 heads
(GQA kv=8), d_ff 14336, vocab 49152 — llama-style SwiGLU + RMSNorm + RoPE."""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="lm",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=49152,
        max_seq_len=4096,
        act="swiglu",
        norm="rmsnorm",
        rope="rope",
        attention=AttentionConfig(kind="flow"),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(kind="flow", chunk_size=32),
    )
