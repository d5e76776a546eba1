"""Mamba2-1.3B [arXiv:2405.21060]: 48L, d_model 2048, attention-free SSD
(d_state 128, expand 2, head_dim 64), vocab 50280, no FFN (d_ff=0).

The paper's Flow-Attention is inapplicable (no attention anywhere); SSD is
decay-gated chunked linear attention, so its chunk scan (``kernels/
ssd_chunk``) has the shape of the causal flow kernels'."""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig, SSDConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="lm",
        n_layers=48,
        d_model=2048,
        n_heads=1,  # unused (attention-free)
        d_ff=0,
        vocab_size=50280,
        max_seq_len=8192,
        act="gelu",
        norm="rmsnorm",
        rope="none",
        tie_embeddings=True,
        pattern=("ssd",),
        ssd=SSDConfig(d_state=128, expand=2, head_dim=64, conv_width=4,
                      chunk_size=128),
        attention=AttentionConfig(kind="flow"),  # unused
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, vocab_size=512, max_seq_len=256,
        ssd=SSDConfig(d_state=32, expand=2, head_dim=32, conv_width=4,
                      chunk_size=32),
    )
