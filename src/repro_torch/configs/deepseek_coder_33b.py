"""DeepSeek-Coder 33B [arXiv:2401.14196]: 62L, d_model 7168, 56 heads (GQA
kv=8), d_ff 19200, vocab 32256 — llama-style SwiGLU + RMSNorm + RoPE."""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="lm",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab_size=32256,
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
