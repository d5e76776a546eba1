"""Nemotron-4 15B [arXiv:2402.16819]: 32L, d_model 6144, 48 heads (GQA kv=8),
d_ff 24576, vocab 256000 — squared-ReLU MLP, no bias, RoPE."""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        family="lm",
        n_layers=32,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=256000,
        max_seq_len=4096,
        act="squared_relu",
        norm="layernorm",
        rope="rope",
        attention=AttentionConfig(kind="flow"),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(kind="flow", chunk_size=32),
    )
