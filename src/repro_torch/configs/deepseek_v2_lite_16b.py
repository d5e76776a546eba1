"""DeepSeek-V2-Lite 16B [arXiv:2405.04434]: 27L, d_model 2048, 16 heads,
MLA (kv_lora 512, rope head 64, nope head 128, v head 128), MoE with
2 shared + 64 routed experts top-6, expert d_ff 1408, vocab 102400.

Assignment-sheet conflict: header says "MoE 64e top-6", trailing note says
"160 routed" (that is full V2); we implement 64 routed — the real V2-Lite —
as documented in DESIGN.md §5.  First dense layer replaced by MoE uniformly
(real model keeps layer 0 dense; we keep all-MoE for homogeneous scan —
parameter delta < 0.5%, noted in DESIGN.md)."""
import dataclasses

from repro_torch.config import AttentionConfig, MLAConfig, MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="lm",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        max_seq_len=4096,
        act="swiglu",
        norm="rmsnorm",
        rope="rope",
        attention=AttentionConfig(kind="flow"),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(n_experts=64, n_shared=2, top_k=6, d_ff_expert=1408,
                      capacity_factor=1.25),
    )


def smoke_config() -> ModelConfig:
    base = config()
    return dataclasses.replace(
        base, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(kind="flow", chunk_size=32),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, rope_head_dim=16,
                      nope_head_dim=32, v_head_dim=32),
        moe=MoEConfig(n_experts=8, n_shared=2, top_k=2, d_ff_expert=64,
                      capacity_factor=2.0),
    )
