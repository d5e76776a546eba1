"""Paper's UEA time-series config (§4.4): 2 layers, 512 hidden, 8 heads."""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="flowformer-timeseries",
        family="lm",  # encoder used via pooling in the bench harness
        n_layers=2,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=16,  # unused: inputs are continuous (stub frontend)
        max_seq_len=2048,
        act="gelu",
        norm="layernorm",
        rope="rope",
        embedding_frontend="stub",
        attention=AttentionConfig(kind="flow", strict_causal=False),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(config(), d_model=64, n_heads=2, n_kv_heads=2,
                               d_ff=128, max_seq_len=256)
