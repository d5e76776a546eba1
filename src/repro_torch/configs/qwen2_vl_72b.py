"""Qwen2-VL 72B backbone [arXiv:2409.12191]: 80L, d_model 8192, 64 heads
(GQA kv=8), d_ff 29568, vocab 152064 — SwiGLU, RMSNorm, M-RoPE
(sections t/h/w = 16/24/24 frequency pairs of the 128-dim head).  The ViT
patch frontend is a STUB: ``input_specs()`` provides patch embeddings and
3D positions."""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="lm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        max_seq_len=32768,
        act="swiglu",
        norm="rmsnorm",
        rope="mrope",
        mrope_sections=(16, 24, 24),
        embedding_frontend="stub",
        attention=AttentionConfig(kind="flow"),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512, max_seq_len=256,
        mrope_sections=(4, 2, 2),  # head_dim 16 -> 8 pairs
        attention=AttentionConfig(kind="flow", chunk_size=32),
    )
