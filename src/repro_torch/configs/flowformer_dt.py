"""Paper's Decision-Flowformer config (§4.5): 3 layers, 256 hidden, 4 heads,
causal Flow-Attention over (rtg, state, action) trajectory tokens."""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="flowformer-dt",
        family="decision",
        n_layers=3,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=1024,
        vocab_size=0,
        max_seq_len=180,  # 60 timesteps x 3 tokens
        act="gelu",
        norm="layernorm",
        rope="none",
        attention=AttentionConfig(kind="flow", chunk_size=0),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=2,
                               n_kv_heads=2, d_ff=128)
