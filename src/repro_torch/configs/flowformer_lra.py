"""Paper's LRA encoder config (§4.1): vanilla Transformer encoder with
Flow-Attention swapped in, following the official LRA protocol sizes."""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="flowformer-lra",
        family="lm",  # encoder used as a classifier via pooling in the bench
        n_layers=4,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=1024,
        vocab_size=256,  # byte-level tasks
        max_seq_len=4096,
        act="gelu",
        norm="layernorm",
        rope="rope",
        attention=AttentionConfig(kind="flow", strict_causal=False),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=2,
                               n_kv_heads=2, d_ff=128, max_seq_len=512)
