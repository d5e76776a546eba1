"""Whisper-small backbone [arXiv:2212.04356]: enc-dec, 12L each, d_model 768,
12 heads, d_ff 3072, vocab 51865 — GELU, pre-LN.  The strided-conv audio
stem is a STUB: the encoder takes precomputed frame embeddings."""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="encdec",
        n_layers=12,
        n_encoder_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        max_seq_len=32768,  # assigned prefill_32k shape (real model: 1500)
        act="gelu",
        norm="layernorm",
        rope="rope",  # decoder self-attention; encoder uses learned abs pos
        embedding_frontend="stub",
        attention=AttentionConfig(kind="flow"),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, n_encoder_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(kind="flow", chunk_size=32),
    )
