"""RecurrentGemma-9B [arXiv:2402.19427 Griffin]: 38L, d_model 4096, pattern
(rglru, rglru, local-attn) -- 16 heads MQA (kv=1) for the attention slots,
window 2048, d_ff 12288 (GeGLU approx. as SwiGLU), vocab 256000.

The paper's technique applies to the attention slots only (RG-LRU layers are
attention-free): in flow mode the 1-in-3 attention layers run causal
Flow-Attention (D = Dv = 256, G = 16: K1 and K3); in softmax mode they run
local sliding-window attention as in Griffin."""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig, RGLRUConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="lm",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab_size=256000,
        max_seq_len=8192,
        act="swiglu",
        norm="rmsnorm",
        rope="rope",
        pattern=("rglru", "rglru", "local"),
        rglru=RGLRUConfig(conv_width=4, lru_width=0, n_blocks=16),
        attention=AttentionConfig(kind="flow", window=2048),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=3, d_model=128, n_heads=4, n_kv_heads=1,
        d_ff=256, vocab_size=512, max_seq_len=256,
        rglru=RGLRUConfig(conv_width=4, lru_width=0, n_blocks=4),
        attention=AttentionConfig(kind="flow", window=64, chunk_size=32),
    )
