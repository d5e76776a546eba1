"""Paper's hierarchical vision Flowformer (§4.3 Tab. 8): 4 stages,
layers (3,3,10,3), channels (96,192,384,768), 16 heads, 224x224 inputs."""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="flowformer-vision",
        family="vision",
        n_layers=19,
        d_model=96,
        n_heads=16,
        n_kv_heads=16,
        d_ff=384,
        vocab_size=0,
        max_seq_len=3136,
        act="gelu",
        norm="layernorm",
        rope="none",
        stage_layers=(3, 3, 10, 3),
        stage_channels=(96, 192, 384, 768),
        n_classes=1000,
        attention=AttentionConfig(kind="flow", strict_causal=False),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), stage_layers=(1, 1, 1, 1), stage_channels=(32, 64, 96, 128),
        n_heads=4, n_classes=10,
    )
