"""Paper's WikiText-103 LM config (§4.2): 6 decoder layers, 8 heads,
512 hidden, FFN 2048, seq len 512 (fairseq protocol)."""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="flowformer-lm",
        family="lm",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=32768,
        max_seq_len=512,
        act="gelu",
        norm="layernorm",
        rope="rope",
        attention=AttentionConfig(kind="flow"),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=128, n_heads=4,
                               n_kv_heads=4, d_ff=256, vocab_size=512,
                               max_seq_len=256)
