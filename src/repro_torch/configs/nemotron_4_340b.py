"""Nemotron-4 340B [arXiv:2402.16819]: 96L, d_model 18432, 96 heads (GQA
kv=8), d_ff 73728, vocab 256000 — squared-ReLU MLP, RoPE."""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b",
        family="lm",
        n_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        d_ff=73728,
        vocab_size=256000,
        max_seq_len=4096,
        act="squared_relu",
        norm="layernorm",
        rope="rope",
        attention=AttentionConfig(kind="flow"),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=3, d_model=192, n_heads=12, n_kv_heads=2,
        d_ff=384, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(kind="flow", chunk_size=32),
    )
