"""Attention layer: the flow branch (the paper's mechanism), the softmax
branch (the Transformer baseline it replaces), the linear branch (the
paper's ablation baseline, Katharopoulos et al.) and the local
sliding-window branch (RecurrentGemma's attention slots in softmax mode).

The counterpart of ``repro/layers/attention.py`` for ``kind`` "flow",
"softmax", "linear" and "local", and for DeepSeek-V2's MLA (multi-head
latent attention) with "flow": q and k decompressed to [nope | rope] per
head (D = nope + rope, Dv = v, one kv head a query head), the flow state
its cache.  MLA with softmax is refused by name: its decode is the
reference's absorbed form over a compressed ``MLACache``.  The "local"
pattern slots of a hybrid stack register their own mixer
(``LocalSlotMixer``): sliding-window attention under softmax mode, flow
attention in flow mode (``_local_cfg``).
Positions are RoPE, or M-RoPE (Qwen2-VL) on (B, 3, N) (t, h, w) streams.
Modes:

  * full     -- whole sequence, no cache (``attention``); with
               ``kv_input`` the encoder-decoder's cross-attention, queries
               from the decoder against keys and values of the memory;
  * prefill  -- whole prompt, returns the decode cache; with ``lengths`` a
               right-padded batch of prompts with per-row boundary caches;
  * decode   -- one token on the cache;
  * verify   -- a drafted window of n tokens (speculative decoding): flow
               scores it in one pass through the registry's ``verify`` op
               and keeps the fp32 trajectory for rollback; linear decodes
               it token by token and stacks the states into a trajectory;
               softmax decodes it token by token and keeps the final
               cache, whose ``pos`` rollback rewinds.

Caches:

  * flow     -- the O(d^2) ``FlowState``, or a ``QuantizedPool`` of one
               when the plan's ``state_dtype`` is int8 (the pool passes to
               the executor unchanged);
  * linear   -- the O(d^2) ``LinearState`` (fp32 s and z per query head),
               or a ``QuantizedPool`` of one that each decode dequantizes,
               updates in fp32 and requantizes with a fresh amax;
  * local    -- a ring ``KVCache`` of min(window, max_len) positions:
               decode writes at t % window and attends the ring's valid
               rows (softmax does not see their order); prefill keeps the
               last window positions aligned to n % window.  It never
               packs, pages, verifies or quantizes (the reference's
               verdicts), so a hybrid stack with it admits one request at
               a time;
  * softmax  -- a dense ``KVCache`` (B, Hkv, L, D) written at each slot's
               position, or a ``PagedKVCache`` page pool when the plan is
               paged (``serving/paged.py``), either one optionally a
               ``QuantizedPool`` with per-token scales.  Decode writes the
               token's K/V rows into the cache in place (the reference
               returns a new cache; a copy of the pool per step would
               double its bytes).  Paged decode lays each slot's pages out
               as one sequence through the page-table gathers, K8a
               (``kernels.gather.paged_gather``) on full-precision pools
               and K8b (``paged_gather_quant``) on int8 pools, which
               dequantizes inline.

The linear branch applies elu + 1 in fp32 and computes its causal
numerator with ``attention.dots.causal_dot_grouped``: on a CUDA tensor the
causal dot K5a (and K5b in its backward), as the reference's reaches its
Pallas chunk dot on the TPU; its decode is plain einsums, as the
reference's is plain XLA.

Which flow kernel or scan realizes the math is resolved by the
``repro_torch.attention`` registry from the ``ExecutionPlan`` built once
(``plan_of``); this layer never names a flow execution path.  The linear
branch's causal dot takes its choice from the same plan: the plain dot
where the plan pins plain PyTorch (``registry.pins_plain``:
``backend="plain"`` or a plain backend by name), K5a on a CUDA tensor
otherwise.  A caller that runs many steps binds the plan once
(``executor_of``) and passes the ``BoundExecutor`` as ``plan``, so no step
re-resolves a backend.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.attention import BoundExecutor, ExecutionPlan, init_state
from repro_torch.attention.dots import causal_dot_grouped
from repro_torch.attention.registry import ShardSpec, pins_plain
from repro_torch.distribution.act_sharding import constrain_heads
from repro_torch.config import ModelConfig
from repro_torch.core.flow_attention import FlowConfig, phi_map
from repro_torch.kernels.gather import paged_gather, paged_gather_quant
from repro_torch.layers import mixer as mixer_lib
from repro_torch.layers.linear import dense, dense_init
from repro_torch.layers.rope import apply_mrope, apply_rope
from repro_torch.serving import quant as quant_lib
from repro_torch.serving.paged import PagedKVCache, PagedSpec, pages_for
from repro_torch.utils import resolve_device

_PORTED = ("flow", "softmax", "linear", "local")


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Hkv, L, D)
    v: torch.Tensor  # (B, Hkv, L, Dv)
    pos: torch.Tensor  # (B,) int32 -- tokens written per slot


class LinearState(NamedTuple):
    s: torch.Tensor  # (B, Hq, D, Dv) fp32
    z: torch.Tensor  # (B, Hq, D) fp32
    pos: torch.Tensor  # (B,) int32


def _require_ported(cfg: ModelConfig):
    if cfg.attention.kind not in _PORTED:
        raise NotImplementedError(
            f"attention kind {cfg.attention.kind!r} is not ported yet "
            f"(ported: {_PORTED})")
    if cfg.mla is not None and cfg.attention.kind != "flow":
        raise NotImplementedError(
            f"attention kind {cfg.attention.kind!r} with MLA is not ported "
            "yet: its decode is the absorbed form over an MLACache "
            "(compressed latent rows, int8 ones in int8 pools); MLA serves "
            "with kind 'flow', whose cache is the FlowState")


@functools.lru_cache(maxsize=64)
def _local_cfg(cfg: ModelConfig) -> ModelConfig:
    """A hybrid stack's "local" slot: sliding-window attention under
    softmax mode, flow attention in flow mode (the paper's replacement)."""
    if cfg.attention.kind == "flow":
        return cfg
    att = dataclasses.replace(cfg.attention, kind="local")
    return dataclasses.replace(cfg, attention=att)


def dataclass_replace_attn(cfg: ModelConfig, kind: str) -> ModelConfig:
    """Narrow a model config to one attention pattern slot ("attn" or
    "local")."""
    if kind == "local":
        return _local_cfg(cfg)
    return cfg


def flow_cfg_of(cfg: ModelConfig, causal: bool) -> FlowConfig:
    a = cfg.attention
    return FlowConfig(
        phi=a.phi,
        causal=causal,
        strict_causal=a.strict_causal,
        use_competition=a.use_competition,
        use_allocation=a.use_allocation,
        chunk_size=a.chunk_size,
        gqa_mode=a.gqa_mode,
        backend=a.backend,
    )


def plan_of(cfg: ModelConfig, *, causal: bool = True, packed: bool = False,
            paged: PagedSpec | None = None, needs_grad: bool = False,
            state_dtype: str | None = None,
            shard: ShardSpec | None = None) -> ExecutionPlan:
    """Build the model-level ``ExecutionPlan`` once; ``flow`` comes from
    ``cfg.attention``; ``paged`` a ``PagedSpec`` for softmax KV caches
    (layers that cannot page serve unpaged); ``needs_grad`` for a
    training step; ``state_dtype`` the serving state pools' dtype (None,
    "bf16" and "fp32" keep the fp32 FlowState and set the KV caches'
    dtype, "int8" and "fp8" quantize every pool); ``shard`` a
    ``ShardSpec`` for sequence-parallel execution (the ``cp_*`` glue).
    The plan's ``speculate_k`` is the serving ``Engine``'s to set."""
    return ExecutionPlan(flow=flow_cfg_of(cfg, causal), packed=packed,
                         paged=paged, needs_grad=needs_grad,
                         state_dtype=state_dtype, shard=shard)


def executor_of(cfg: ModelConfig, plan: ExecutionPlan | None = None, *,
                causal: bool = True) -> BoundExecutor:
    """Bind ``plan`` (default ``plan_of(cfg)``) with ``flow`` from
    ``cfg.attention``, once."""
    fc = flow_cfg_of(cfg, causal)
    return BoundExecutor(ExecutionPlan(flow=fc) if plan is None
                         else dataclasses.replace(plan, flow=fc))


def _flow_executor(cfg: ModelConfig, causal: bool,
                   plan: ExecutionPlan | BoundExecutor | None) -> BoundExecutor:
    if isinstance(plan, BoundExecutor):
        return plan
    return executor_of(cfg, plan, causal=causal)


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """``wq``, ``wk``, ``wv``, ``wo``; with MLA ``kv_down`` (d, kv_lora +
    rope), ``kv_up`` (kv_lora, H (nope + v)), ``wo`` (H v, d) and ``wq``
    (d, H (nope + rope)) or, with a query LoRA, ``q_down`` and ``q_up``,
    drawn in the reference's order."""
    _require_ported(cfg)
    d, hd = cfg.d_model, cfg.dim_head
    nq, nkv = cfg.n_heads, cfg.kv_heads
    if cfg.mla is not None:
        m = cfg.mla
        qdim = nq * (m.nope_head_dim + m.rope_head_dim)
        p = {"kv_down": dense_init(gen, d, m.kv_lora_rank + m.rope_head_dim),
             "kv_up": dense_init(gen, m.kv_lora_rank,
                                 nq * (m.nope_head_dim + m.v_head_dim)),
             "wo": dense_init(gen, nq * m.v_head_dim, d)}
        if m.q_lora_rank:
            p["q_down"] = dense_init(gen, d, m.q_lora_rank)
            p["q_up"] = dense_init(gen, m.q_lora_rank, qdim)
        else:
            p["wq"] = dense_init(gen, d, qdim)
        return p
    return {
        "wq": dense_init(gen, d, nq * hd),
        "wk": dense_init(gen, d, nkv * hd),
        "wv": dense_init(gen, d, nkv * hd),
        "wo": dense_init(gen, nq * hd, d),
    }


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, n, _ = x.shape
    return x.reshape(b, n, n_heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _apply_positions(q, k, cfg: ModelConfig, positions):
    if positions is None or cfg.rope in ("none", "learned"):
        return q, k
    if cfg.rope == "rope":
        return (apply_rope(q, positions, theta=cfg.rope_theta),
                apply_rope(k, positions, theta=cfg.rope_theta))
    if cfg.rope == "mrope":  # positions (B, 3, N): the (t, h, w) streams
        return (apply_mrope(q, positions, cfg.mrope_sections,
                            theta=cfg.rope_theta),
                apply_mrope(k, positions, cfg.mrope_sections,
                            theta=cfg.rope_theta))
    raise ValueError(cfg.rope)


def _project_qkv_mla(params, x: torch.Tensor, cfg: ModelConfig, positions):
    """DeepSeek-V2's MLA in its decompressed form: per head q and k =
    [nope | rope], k's rope part the one shared rope head of the latent
    projection broadcast over the heads, and v; q, k (B, H, N, nope +
    rope), v (B, H, N, v)."""
    m = cfg.mla
    nq = cfg.n_heads
    if m.q_lora_rank:
        q = dense(params["q_up"], dense(params["q_down"], x))
    else:
        q = dense(params["wq"], x)
    q = _split_heads(q, nq)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    ckv = dense(params["kv_down"], x)  # (B, N, kv_lora + rope)
    c_kv, k_rope = ckv.split([m.kv_lora_rank, m.rope_head_dim], dim=-1)
    kv = _split_heads(dense(params["kv_up"], c_kv), nq)
    k_nope, v = kv.split([m.nope_head_dim, m.v_head_dim], dim=-1)
    k_rope = k_rope[:, None]  # the shared rope head (B, 1, N, rope)
    if positions is not None and cfg.rope != "none":
        q_rope = apply_rope(q_rope, positions, theta=cfg.rope_theta)
        k_rope = apply_rope(k_rope, positions, theta=cfg.rope_theta)
    k_rope = k_rope.expand(*k_nope.shape[:-1], m.rope_head_dim)
    return (torch.cat([q_nope, q_rope], dim=-1),
            torch.cat([k_nope, k_rope], dim=-1), v)


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig, positions,
                 kv_input: torch.Tensor | None = None):
    """Per-head q, k, v with positional encoding applied; with
    ``kv_input``, k and v from it and no positions (cross-attention).
    MLA projects through its latent (``_project_qkv_mla``)."""
    if cfg.mla is not None:
        if kv_input is not None:
            raise ValueError("MLA cross-attention is used by no arch")
        return _project_qkv_mla(params, x, cfg, positions)
    src = x if kv_input is None else kv_input
    q = constrain_heads(_split_heads(dense(params["wq"], x), cfg.n_heads))
    k = constrain_heads(_split_heads(dense(params["wk"], src), cfg.kv_heads))
    v = constrain_heads(_split_heads(dense(params["wv"], src), cfg.kv_heads))
    if kv_input is None:
        q, k = _apply_positions(q, k, cfg, positions)
    return q, k, v


def _softmax_attn(q, k, v, *, causal: bool, softcap: float = 0.0,
                  q_offset: int = 0, kv_len: torch.Tensor | None = None):
    """GQA softmax attention, O(n m).  q: (B, Hq, N, D); k, v: (B, Hkv, M,
    D | Dv); the Hq / Hkv query heads of a group share their kv head,
    kv-major (``q.reshape(B, Hkv, G, N, D)``).  Logits in fp32 from the
    exact products of the inputs, times D^-0.5; softcap; the causal mask
    (query i + q_offset sees keys <= it) and the ``kv_len`` (B, 1) mask set
    logits to -1e30; softmax in fp32, cast to v's dtype before the second
    product."""
    b, hq, n, d = q.shape
    hkv, m = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, n, d)
    logits = torch.einsum("bhgnd,bhmd->bhgnm", qg.float(), k.float()) \
        * (d ** -0.5)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    cols = torch.arange(m, device=q.device)
    if causal:
        qpos = torch.arange(n, device=q.device) + q_offset
        mask = qpos[:, None] >= cols[None, :]
        logits = torch.where(mask, logits, -1e30)
    if kv_len is not None:
        valid = cols[None, :] < kv_len.to(q.device)  # (B, M)
        logits = torch.where(valid[:, None, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgnm,bhme->bhgne", w, v)
    return out.reshape(b, hq, n, -1)


def _local_attn(q, k, v, *, window: int, softcap: float = 0.0):
    """Sliding-window causal attention (a band of ``window`` keys ending
    at each query), O(n W).  Up to one window it is ``_softmax_attn``;
    past it n must be a multiple of the window (``ValueError`` otherwise,
    as the reference asserts): each window-sized block of queries attends
    to [previous block | its own block] under the band mask, the first
    block's previous one zero padding masked off.  Logits in fp32 from
    the exact products, masked to -1e30, softmax in fp32 cast to v's
    dtype, as the reference writes it."""
    b, hq, n, d = q.shape
    if n <= window:
        return _softmax_attn(q, k, v, causal=True, softcap=softcap)
    w = window
    if n % w:
        raise ValueError(f"seq {n} must be divisible by window {w} "
                         "(local attention past one window)")
    hkv, nc = k.shape[1], n // w
    kp = torch.cat([torch.zeros_like(k[:, :, :w]), k], dim=2)
    vp = torch.cat([torch.zeros_like(v[:, :, :w]), v], dim=2)
    # block c of keys and values: padded positions [c w, (c + 2) w)
    kc = kp.unfold(2, 2 * w, w).permute(0, 1, 2, 4, 3)  # (B, Hkv, nc, 2w, D)
    vc = vp.unfold(2, 2 * w, w).permute(0, 1, 2, 4, 3)
    qg = q.reshape(b, hkv, hq // hkv, nc, w, d)
    logits = torch.einsum("bhgcnd,bhcmd->bhgcnm", qg.float(), kc.float()) \
        * (d ** -0.5)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(w, device=q.device)[:, None] + w  # within the band
    kpos = torch.arange(2 * w, device=q.device)[None, :]
    mask = (qpos >= kpos) & (kpos > qpos - w)
    first = kpos >= w  # the first block's "previous" block is padding
    cmask = torch.where((torch.arange(nc, device=q.device) == 0)[:, None, None],
                        (mask & first)[None], mask[None])  # (nc, w, 2w)
    logits = torch.where(cmask, logits, -1e30)
    wts = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgcnm,bhcme->bhgcne", wts, vc)
    return out.reshape(b, hq, n, -1)


def _repeat_kv(x: torch.Tensor, hq: int) -> torch.Tensor:
    """(B, Hkv, ...) -> (B, Hq, ...): each kv head for its query heads."""
    return x if x.shape[1] == hq else x.repeat_interleave(hq // x.shape[1], 1)


def _linear_attn(q, k, v, *, causal: bool, phi: str = "elu1",
                 chunk_size: int = 128, eps: float = 1e-6,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """Katharopoulos et al. linear attention, the paper's ablation
    baseline.  q: (B, Hq, N, D); k: (B, Hkv, N, D); v: (B, Hkv, N, Dv).
    phi in fp32; causal: the numerator by the grouped causal dot (the
    query heads of a group share their kv head's sums, as the reference's
    repeated heads do; K5a on a CUDA tensor unless ``use_kernel`` is
    False), the denominator by a cumsum; non-causal: three einsums."""
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    pq = phi_map(q.float(), phi)
    pk = phi_map(k.float(), phi)
    vf = v.float()
    if causal:
        num = causal_dot_grouped(pq.reshape(b, hkv, hq // hkv, n, d), pk, vf,
                                 chunk_size, use_kernel=use_kernel
                                 ).reshape(b, hq, n, -1)
        den = torch.einsum("bhnd,bhnd->bhn", pq,
                           torch.cumsum(_repeat_kv(pk, hq), dim=2))
    else:
        pk, vf = _repeat_kv(pk, hq), _repeat_kv(vf, hq)
        kv = torch.einsum("bhmd,bhme->bhde", pk, vf)
        num = torch.einsum("bhnd,bhde->bhne", pq, kv)
        den = torch.einsum("bhnd,bhd->bhn", pq, pk.sum(dim=2))
    return (num / (den[..., None] + eps)).to(q.dtype)


def _linear_kernel(cfg: ModelConfig, plan) -> bool | None:
    """The linear branch's causal dot, from the plan: the plain dot
    (False) where it pins plain PyTorch, else K5a on a CUDA tensor
    (None)."""
    flow = _flow_executor(cfg, True, plan).plan.flow
    return False if pins_plain(flow) else None


def attention(params, x: torch.Tensor, cfg: ModelConfig, *, causal: bool,
              positions=None, kv_input: torch.Tensor | None = None,
              plan: ExecutionPlan | BoundExecutor | None = None):
    """Full-sequence attention.  x: (B, N, d_model).  ``kv_input`` (B, M,
    d_model) is the cross-attention memory (the encoder-decoder): q comes
    from ``x``, k and v from the memory, and no positions are applied, so
    the flow executor runs the rectangular case N != M (non-causal)."""
    _require_ported(cfg)
    q, k, v = _project_qkv(params, x, cfg, positions, kv_input)
    kind = cfg.attention.kind
    if kind == "flow":
        out = _flow_executor(cfg, causal, plan).forward(q, k, v)
    elif kind == "linear":
        out = _linear_attn(q, k, v, causal=causal,
                           chunk_size=cfg.attention.chunk_size,
                           use_kernel=_linear_kernel(cfg, plan))
    elif kind == "local":
        out = _local_attn(q, k, v, window=cfg.attention.window,
                          softcap=cfg.attention.softcap)
    else:
        out = _softmax_attn(q, k, v, causal=causal,
                            softcap=cfg.attention.softcap)
    return dense(params["wo"], _merge_heads(out))


def _attn_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, *, paged: PagedSpec | None = None,
                     device="cuda"):
    """Decode cache for one layer on ``device`` (the card unless the caller
    asks for the CPU): the O(d^2) FlowState, fp32, for flow (with MLA one
    per query head, (nope + rope) x v); the
    ``LinearState`` (fp32, per query head) for linear; for softmax a
    dense ``KVCache`` of ``max_len`` positions in ``dtype``, or with
    ``paged`` a ``PagedKVCache`` of ``paged.num_pages`` pages (0: the
    dense-equivalent ``batch * ceil(max_len / page_size)``) plus the trash
    page; for local a ring ``KVCache`` of min(window, max_len)
    positions."""
    _require_ported(cfg)
    dev = resolve_device(device)
    hd, nkv = cfg.dim_head, cfg.kv_heads
    if cfg.mla is not None:  # flow: a state per head, D = nope + rope
        m = cfg.mla
        return init_state(batch, cfg.n_heads,
                          m.nope_head_dim + m.rope_head_dim, m.v_head_dim,
                          device=dev)
    if cfg.attention.kind == "flow":
        return init_state(batch, nkv, hd, hd, device=dev)
    pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if cfg.attention.kind == "linear":
        f32 = dict(dtype=torch.float32, device=dev)
        return LinearState(torch.zeros((batch, cfg.n_heads, hd, hd), **f32),
                           torch.zeros((batch, cfg.n_heads, hd), **f32), pos)
    if paged is not None:
        p = paged.num_pages or batch * pages_for(max_len, paged.page_size)
        shape = (p + 1, nkv, paged.page_size, hd)
    elif cfg.attention.kind == "local":
        shape = (batch, nkv, min(cfg.attention.window, max_len), hd)
    else:
        shape = (batch, nkv, max_len, hd)
    return (PagedKVCache if paged is not None else KVCache)(
        torch.zeros(shape, dtype=dtype, device=dev),
        torch.zeros(shape, dtype=dtype, device=dev), pos)


def _attention_prefill(params, x: torch.Tensor, cfg: ModelConfig,
                       max_len: int, *, positions=None, lengths=None,
                       plan: ExecutionPlan | BoundExecutor | None = None):
    """Prompt prefill returning (out, cache).  ``lengths`` (B,) serves a
    right-padded batch of prompts: causality keeps every true position
    exact, each row's cache state lands at its own boundary, and outputs
    at padded positions are never read.  Flow returns the FlowState;
    linear the ``LinearState`` of phi(k) masked past each row's length;
    softmax a dense ``KVCache`` padded to ``max_len`` in the activation
    dtype; local its ring of min(window, max_len) positions holding the
    last ones, position i at i % window (it has no packed form: a
    ``lengths`` raises ``MixerResolutionError``); ``pos`` = ``lengths`` (or
    N)."""
    _require_ported(cfg)
    q, k, v = _project_qkv(params, x, cfg, positions)
    if cfg.attention.kind == "flow":
        out, state = _flow_executor(cfg, True, plan).prefill(
            q, k, v, lengths=lengths)
        return dense(params["wo"], _merge_heads(out)), state
    b, n, _ = x.shape
    pos0 = (torch.full((b,), n, dtype=torch.int32, device=x.device)
            if lengths is None
            else lengths.to(device=x.device, dtype=torch.int32))
    if cfg.attention.kind == "linear":
        out = _linear_attn(q, k, v, causal=True,
                           chunk_size=cfg.attention.chunk_size,
                           use_kernel=_linear_kernel(cfg, plan))
        pk = phi_map(_repeat_kv(k, cfg.n_heads).float(), "elu1")
        if lengths is not None:
            valid = torch.arange(n, device=x.device)[None, :] < pos0[:, None]
            pk = pk * valid.float()[:, None, :, None]
        s = torch.einsum("bhnd,bhne->bhde", pk,
                         _repeat_kv(v, cfg.n_heads).float())
        return (dense(params["wo"], _merge_heads(out)),
                LinearState(s, pk.sum(dim=2), pos0))
    if cfg.attention.kind == "local":
        if lengths is not None:
            raise mixer_lib.MixerResolutionError(
                "local attention cannot satisfy packed prefill -- missing "
                "capability packable: per-row ring alignment is "
                "length-dependent",
                (("local", "packable", "per-row ring alignment"),))
        out = _local_attn(q, k, v, window=cfg.attention.window,
                          softcap=cfg.attention.softcap)
        w = min(cfg.attention.window, max_len)
        # the last `take` positions, position i at ring index i % w
        take = min(w, n)
        idx = ((n - take) % w + torch.arange(take, device=x.device)) % w
        ring = []
        for t in (k, v):
            r = torch.zeros((b, cfg.kv_heads, w, cfg.dim_head), dtype=t.dtype,
                            device=x.device)
            r[:, :, idx] = t[:, :, n - take:]
            ring.append(r)
        return dense(params["wo"], _merge_heads(out)), KVCache(*ring, pos0)
    out = _softmax_attn(q, k, v, causal=True, softcap=cfg.attention.softcap)
    pad = (0, 0, 0, max_len - n)
    cache = KVCache(F.pad(k, pad).to(x.dtype), F.pad(v, pad).to(x.dtype), pos0)
    return dense(params["wo"], _merge_heads(out)), cache


def _attention_decode(params, x: torch.Tensor, cache, cfg: ModelConfig, *,
                      positions=None, page_table=None,
                      plan: ExecutionPlan | BoundExecutor | None = None):
    """One-token decode.  x: (B, 1, d_model) -> (out, new_cache).

    ``page_table`` (B, pages_per_slot) maps slots to pool pages when the
    cache is a ``PagedKVCache`` (ignored otherwise)."""
    _require_ported(cfg)
    q, k, v = _project_qkv(params, x, cfg, positions)
    if cfg.attention.kind == "flow":
        new_state, out = _flow_executor(cfg, True, plan).decode_step(
            cache, q, k, v)
        return dense(params["wo"], _merge_heads(out)), new_state
    if cfg.attention.kind == "linear":
        return _linear_decode(params, x, q, k, v, cache, cfg)
    pool = cache if isinstance(cache, quant_lib.QuantizedPool) else None
    store = pool.payload if pool is not None else cache
    if isinstance(store, PagedKVCache):
        return _paged_decode(params, q, k, v, cache, cfg, page_table)
    # dense: each slot writes at its own position, clamped to the cache's
    # end (a local ring: at t % window); then attend over the first kv_len
    # positions
    t = store.pos
    cache_len = store.k.shape[2]
    rows = torch.arange(x.shape[0], device=x.device)
    idx = (t % cache_len if cfg.attention.kind == "local"
           else t.clamp(max=cache_len - 1)).long()
    kv_len = (t + 1).clamp(max=cache_len)
    _write_rows(pool, store, (rows, slice(None), idx), k, v)
    new_cache = KVCache(store.k, store.v, t + 1)
    ka, va = store.k, store.v
    if pool is not None:  # the whole cache dequantized, rounded once
        ka = (ka.float() * pool.scale.k).to(q.dtype)
        va = (va.float() * pool.scale.v).to(q.dtype)
        new_cache = pool.with_state(new_cache, pool.scale)
    out = _softmax_attn(q, ka, va, causal=False,
                        softcap=cfg.attention.softcap, kv_len=kv_len[:, None])
    return dense(params["wo"], _merge_heads(out)), new_cache


def _linear_decode(params, x, q, k, v, cache, cfg: ModelConfig):
    """The linear branch's decode: s += phi(k) v^T, z += phi(k), out =
    phi(q) s / (phi(q) . z + 1e-6), in fp32 einsums.  An int8
    ``QuantizedPool`` is dequantized, updated in fp32 and requantized whole
    with a fresh per-(slot, head) amax: the state is rewritten every step."""
    pool = cache if isinstance(cache, quant_lib.QuantizedPool) else None
    st = quant_lib.dequantize_state(pool) if pool is not None else cache
    pq = phi_map(q.float(), "elu1")[:, :, 0]
    pk = _repeat_kv(phi_map(k.float(), "elu1")[:, :, 0], cfg.n_heads)
    vv = _repeat_kv(v[:, :, 0].float(), cfg.n_heads)
    s = st.s + torch.einsum("bhd,bhe->bhde", pk, vv)
    z = st.z + pk
    num = torch.einsum("bhd,bhde->bhe", pq, s)
    den = torch.einsum("bhd,bhd->bh", pq, z) + 1e-6
    out = (num / den[..., None])[:, :, None].to(x.dtype)
    new_state = LinearState(s, z, st.pos + 1)
    if pool is not None:
        new_state = quant_lib.quantize_like(pool, new_state)
    return dense(params["wo"], _merge_heads(out)), new_state


def _write_rows(pool, store, index, k, v):
    """Write this token's K/V rows (B, Hkv, D) at ``index`` of the cache,
    in place; on an int8 pool quantized once per token row, payload and
    scale by the same index."""
    if pool is None:
        store.k[index] = k[:, :, 0].to(store.k.dtype)
        store.v[index] = v[:, :, 0].to(store.v.dtype)
        return
    for x, payload, scale in ((k, store.k, pool.scale.k),
                              (v, store.v, pool.scale.v)):
        payload[index], scale[index] = quant_lib.quantize_leaf(
            x[:, :, 0], pool.spec, "token")


def _paged_decode(params, q, k, v, cache, cfg: ModelConfig, page_table):
    """Softmax decode on the paged pool: write this token's K/V into the
    slot's current page, attend over the gathered page sequence.

    The position is clamped before it is split into page and offset, so
    writes past a slot's capacity land on its last in-page offset, as the
    dense cache's end-of-cache clamp does.  Dead slots' table rows hold
    the sentinel, whose writes land in the trash page; the gathers see
    only the first P pages and clamp sentinel ids into them (garbage that
    ``kv_len`` masks).  ``cache`` may be a ``QuantizedPool`` of the pool:
    the token's rows quantize once on append and K8b dequantizes inline.
    """
    if page_table is None:
        raise ValueError("paged decode requires the page table")
    pool = cache if isinstance(cache, quant_lib.QuantizedPool) else None
    store = pool.payload if pool is not None else cache
    t = store.pos
    n_pages, page = store.k.shape[0] - 1, store.k.shape[2]
    cap = page_table.shape[1] * page
    rows = torch.arange(q.shape[0], device=q.device)
    tc = t.clamp(max=cap - 1).long()
    pid = page_table[rows, tc // page].long()
    _write_rows(pool, store, (pid, slice(None), tc % page), k, v)
    if pool is None:
        kg, vg = paged_gather(store.k[:n_pages], store.v[:n_pages], page_table)
        new_cache = PagedKVCache(store.k, store.v, t + 1)
    else:
        kg, vg = paged_gather_quant(
            store.k[:n_pages], store.v[:n_pages], pool.scale.k[:n_pages],
            pool.scale.v[:n_pages], page_table, out_dtype=q.dtype)
        new_cache = pool.with_state(PagedKVCache(store.k, store.v, t + 1),
                                    pool.scale)
    kv_len = (t + 1).clamp(max=cap)
    out = _softmax_attn(q, kg, vg, causal=False,
                        softcap=cfg.attention.softcap, kv_len=kv_len[:, None])
    return dense(params["wo"], _merge_heads(out)), new_cache


def _plan_paged(plan):
    """The ``PagedSpec`` of a plan or of a ``BoundExecutor``'s plan."""
    return getattr(getattr(plan, "plan", plan), "paged", None)


class AttentionMixer(mixer_lib.Mixer):
    """The attention layer ("attn" pattern slots) as a sequence mixer;
    ``cfg.attention.kind`` switches the mechanism.  ``_cfg`` narrows the
    model's config to the slot's (``LocalSlotMixer``); every capability is
    judged on it."""

    params_field = "attn"

    def _cfg(self, cfg: ModelConfig) -> ModelConfig:
        return cfg

    def packable(self, cfg):
        if self._cfg(cfg).attention.kind == "local":
            return False, ("local ring buffers have no per-row packed form "
                           "(ring alignment is length-dependent)")
        return True, "per-row boundary caches from one padded causal call"

    def paged_capable(self, cfg):
        cfg = self._cfg(cfg)
        if cfg.mla is not None:
            return False, ("MLA keeps its compressed dense latent cache "
                           "(~an order smaller than raw KV)")
        if cfg.attention.kind == "softmax":
            return True, "dense KV cache pages into the pool"
        if cfg.attention.kind == "local":
            return False, "bounded ring buffer (nothing to page)"
        return False, "constant-size O(d^2) recurrent state (nothing to page)"

    def differentiable(self, cfg, platform):
        return True, ("gradient capability is judged per execution strategy "
                      "by the attention backend registry (needs_grad plans)")

    def verify_capable(self, cfg):
        kind = self._cfg(cfg).attention.kind
        if kind == "local":
            return False, ("ring buffer overwrites history: a rejected "
                           "draft cannot be rolled back")
        if kind == "flow":
            return True, ("registry verify op: one carry-in pass, "
                          "trajectory FlowState rollback")
        if kind == "linear":
            return True, "trajectory rollback over scanned decode"
        return True, ("positional cache: rollback is per-slot position "
                      "arithmetic (stale writes are masked/overwritten)")

    def quant_capable(self, cfg, platform, dtype):
        cfg = self._cfg(cfg)
        kind = cfg.attention.kind
        if kind == "local":
            return False, ("bounded window ring stays full-precision "
                           "(window-sized cache: negligible bytes to win, "
                           "and ring realignment would re-round history)")
        ok, why = quant_lib.platform_support(dtype, platform)
        if not ok:
            return False, why
        if kind == "flow":
            return True, f"quantized FlowState pool ({why})"
        if kind == "linear":
            return True, ("dequantize/requantize around the O(d^2) update "
                          f"({why})")
        if cfg.mla is not None:
            return True, f"per-token quantized latent rows ({why})"
        return True, f"per-token quantized KV rows ({why})"

    def init_params(self, gen, cfg):
        return attn_init(gen, self._cfg(cfg))

    def forward(self, params, x, cfg, *, positions=None, plan=None):
        return attention(params, x, self._cfg(cfg), causal=True,
                         positions=positions, plan=plan)

    def state_init(self, cfg, batch, max_len, *, device="cuda", dtype=None,
                   plan=None):
        # the plan's state_dtype outranks the activation dtype for KV
        # storage: bf16/fp32 set the cache dtype, int8/fp8 wrap the fresh
        # cache in a QuantizedPool; a flow state stays fp32 (or int8)
        sd = quant_lib.state_dtype_of(plan)
        cache_dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}.get(
            sd, dtype or torch.bfloat16)
        paged = _plan_paged(plan) if self.paged_capable(cfg)[0] else None
        return quant_lib.maybe_quantize(
            _attn_cache_init(self._cfg(cfg), batch, max_len, cache_dtype,
                             paged=paged, device=device), plan)

    def prefill(self, params, x, cfg, max_len, *, positions=None,
                lengths=None, plan=None):
        return _attention_prefill(params, x, self._cfg(cfg), max_len,
                                  positions=positions, lengths=lengths,
                                  plan=plan)

    def decode_step(self, params, x, state, cfg, *, positions=None,
                    page_table=None, plan=None):
        return _attention_decode(params, x, state, self._cfg(cfg),
                                 positions=positions, page_table=page_table,
                                 plan=plan)

    def verify_step(self, params, x, state, cfg, *, positions=None,
                    page_table=None, plan=None):
        cfg = self._cfg(cfg)
        if cfg.attention.kind == "local":
            raise mixer_lib.MixerResolutionError(
                "local attention cannot satisfy speculative verify: missing "
                "capability verify_capable: ring buffer overwrites history",
                (("local", "verify_capable", "ring overwrite"),))
        _require_ported(cfg)
        if cfg.attention.kind == "flow":
            # one carry-in pass through the registry's verify op: every
            # position's output and the trajectory FlowState (window axis
            # at index 1); the pool itself is read, never written
            q, k, v = _project_qkv(params, x, cfg, positions)
            out, traj = _flow_executor(cfg, True, plan).verify_step(
                state, q, k, v)
            if isinstance(state, quant_lib.QuantizedPool):
                # verify dequantized once at entry; carry the fp32
                # trajectory with the pool's recipe, so rollback quantizes
                # once, at the accepted boundary
                traj = quant_lib.QuantTraj(traj, state.spec,
                                           state.granularity, state.exempt)
            return dense(params["wo"], _merge_heads(out)), traj
        if cfg.attention.kind == "linear":
            # a constant-size state: the generic scanned-decode trajectory
            # (each step's pool, int8 ones as they were requantized)
            return super().verify_step(params, x, state, cfg,
                                       positions=positions,
                                       page_table=page_table, plan=plan)
        # softmax, dense or paged: a positional cache rolls back by its
        # position, so decode the window token by token and keep only the
        # final cache (n snapshots of the cache would cost n x its bytes)
        out, states = self.decode_window(params, x, state, cfg,
                                         positions=positions,
                                         page_table=page_table, plan=plan)
        return out, states[-1]

    def select_verified(self, pending, accepted, n, cfg, *, plan=None):
        cfg = self._cfg(cfg)
        if isinstance(pending, quant_lib.QuantTraj):
            # gather the accepted fp32 boundary first, then quantize: the
            # rollback's single requantization
            return pending.quantize(mixer_lib.select_from_trajectory(
                pending.traj, accepted))
        if cfg.attention.kind in ("flow", "linear"):
            return mixer_lib.select_from_trajectory(pending, accepted)
        # positional caches: the window wrote n rows at pos .. pos + n - 1;
        # accepting a + 1 of them rewinds pos, so later decodes overwrite
        # the stale tail and ``kv_len`` masks it until then
        pool = pending if isinstance(pending, quant_lib.QuantizedPool) \
            else None
        store = pool.payload if pool is not None else pending
        acc = accepted.to(device=store.pos.device, dtype=store.pos.dtype)
        store = store._replace(pos=store.pos - (n - acc - 1))
        # a quantized pool's scales are per token: the stale tail's are
        # overwritten with its rows
        return pool.with_state(store, pool.scale) if pool is not None \
            else store


class LocalSlotMixer(AttentionMixer):
    """The "local" pattern slots (RecurrentGemma): sliding-window attention
    under softmax mode, flow attention in flow mode; the narrowing happens
    here, so call sites never re-derive it."""

    def _cfg(self, cfg: ModelConfig) -> ModelConfig:
        return _local_cfg(cfg)


mixer_lib.register_mixer("attn", AttentionMixer())
mixer_lib.register_mixer("local", LocalSlotMixer())
