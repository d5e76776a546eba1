"""Unified model/run configuration (a copy of ``repro/config.py``).

The port keeps its own copy so that it imports nothing of the JAX package;
the fields and defaults are the same, field for field, and a test holds
them equal.  The paper's technique is selected with
``attention.kind == "flow"``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

AttnKind = Literal["flow", "softmax", "linear", "local"]


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    kind: AttnKind = "flow"
    # flow attention (the paper)
    phi: str = "sigmoid"
    strict_causal: bool = True  # serving-grade causal competition (DESIGN §1)
    use_competition: bool = True
    use_allocation: bool = True
    chunk_size: int = 128
    gqa_mode: str = "shared"
    # flow execution strategy: "auto" | "plain" | a registered backend
    # name (see the repro_torch.attention registry docs)
    backend: str = "auto"
    # local / sliding-window attention (recurrentgemma)
    window: int = 2048
    # softmax
    softcap: float = 0.0


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    n_shared: int = 0
    top_k: int = 2
    d_ff_expert: int = 0  # per-expert hidden dim
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01
    # "einsum" dense dispatch (TPU-friendly one-hot matmuls)
    capacity_factor: float = 0.0  # 0 => dense full dispatch (exact, no drops)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 => full-rank queries
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    conv_width: int = 4
    lru_width: int = 0  # 0 => d_model
    n_blocks: int = 16  # block-diagonal gate projections (griffin "heads")


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk_size: int = 128
    a_init_range: tuple[float, float] = (1.0, 16.0)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: Literal["lm", "encdec", "vision", "decision"] = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 0  # 0 => n_heads (MHA)
    head_dim: int = 0  # 0 => d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 4096
    act: Literal["squared_relu", "swiglu", "gelu", "relu"] = "gelu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    rope: Literal["rope", "mrope", "none", "learned"] = "rope"
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = (16, 24, 24)  # qwen2-vl (t, h, w)
    tie_embeddings: bool = False
    attention: AttentionConfig = AttentionConfig()
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    ssd: Optional[SSDConfig] = None
    # block kind for each layer position within a repeating period:
    #   ("attn",)                      homogeneous transformer
    #   ("rglru", "rglru", "attn")     recurrentgemma 1:2
    #   ("ssd",)                       mamba-2
    pattern: tuple[str, ...] = ("attn",)
    # enc-dec extras (whisper)
    n_encoder_layers: int = 0
    encoder_causal: bool = False
    # vision extras (paper's hierarchical flowformer)
    stage_layers: tuple[int, ...] = ()
    stage_channels: tuple[int, ...] = ()
    n_classes: int = 0
    # frontend stub: inputs are precomputed embeddings (audio frames / patches)
    embedding_frontend: Literal["tokens", "stub"] = "tokens"
    # training
    remat: bool = True
    scan_layers: bool = True
    logit_softcap: float = 0.0

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def dim_head(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def block_kind(self, layer_idx: int) -> str:
        return self.pattern[layer_idx % len(self.pattern)]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings and self.family in ("lm", "encdec"):
            total += v * d  # output head
        for i in range(self.n_layers):
            total += self._block_params(self.block_kind(i))
        for i in range(self.n_encoder_layers):
            total += self._block_params("attn")
            total += self._cross_attn_params() if False else 0
        if self.family == "encdec":
            # decoder layers also carry cross attention
            total += self.n_layers * self._cross_attn_params()
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.dim_head
        nq, nkv = self.n_heads, self.kv_heads
        if self.mla is not None:
            m = self.mla
            qdim = nq * (m.nope_head_dim + m.rope_head_dim)
            p = d * (m.kv_lora_rank + m.rope_head_dim)  # kv down
            p += m.kv_lora_rank * nq * (m.nope_head_dim + m.v_head_dim)  # kv up
            if m.q_lora_rank:
                p += d * m.q_lora_rank + m.q_lora_rank * qdim
            else:
                p += d * qdim
            p += nq * m.v_head_dim * d  # out proj
            return p
        return d * nq * hd + 2 * d * nkv * hd + nq * hd * d

    def _cross_attn_params(self) -> int:
        return self._attn_params()

    def _ffn_params(self) -> int:
        d, f = self.d_model, self.d_ff
        dense = d * f * (3 if self.act == "swiglu" else 2)
        if self.moe is None:
            return dense
        fe = self.moe.d_ff_expert or f
        per_exp = d * fe * (3 if self.act == "swiglu" else 2)
        total = self.moe.n_experts * per_exp + self.moe.n_shared * per_exp
        total += d * self.moe.n_experts  # router
        return total

    def _block_params(self, kind: str) -> int:
        d = self.d_model
        norms = 2 * d
        if kind == "attn" or kind == "local":
            return self._attn_params() + self._ffn_params() + norms
        if kind == "rglru":
            w = self.rglru.lru_width or d
            p = 2 * d * w + w * d  # in/out projections (x, gate branches)
            p += self.rglru.conv_width * w  # temporal conv
            p += 2 * w  # input & recurrence gates (block-diag approximated dense per block)
            p += 2 * (w // self.rglru.n_blocks) * w  # gate projections
            p += w  # lambda
            return p + self._ffn_params() + norms
        if kind == "ssd":
            s = self.ssd
            d_in = s.expand * d
            nh = d_in // s.head_dim
            p = d * (2 * d_in + 2 * s.d_state + nh)  # in_proj (x,z,B,C,dt)
            p += s.conv_width * (d_in + 2 * s.d_state)
            p += nh + nh  # A_log, D
            p += d_in * d  # out proj
            return p + norms // 2
        raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


LM_SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)
