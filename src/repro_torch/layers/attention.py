"""Attention layer: the flow branch (the paper's mechanism) and the
softmax branch (the Transformer baseline it replaces).

The counterpart of ``repro/layers/attention.py`` for ``kind`` "flow" and
"softmax" (``local``, ``linear`` and MLA are refused by name).  Modes:

  * full     -- whole sequence, no cache (``attention``);
  * prefill  -- whole prompt, returns the decode cache; with ``lengths`` a
               right-padded batch of prompts with per-row boundary caches;
  * decode   -- one token on the cache;
  * verify   -- a drafted window of n tokens (speculative decoding): flow
               scores it in one pass through the registry's ``verify`` op
               and keeps the fp32 trajectory for rollback; softmax decodes
               it token by token and keeps the final cache, whose ``pos``
               rollback rewinds.

Caches:

  * flow     -- the O(d^2) ``FlowState``, or a ``QuantizedPool`` of one
               when the plan's ``state_dtype`` is int8 (the pool passes to
               the executor unchanged);
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

Which flow kernel or scan realizes the math is resolved by the
``repro_torch.attention`` registry from the ``ExecutionPlan`` built once
(``plan_of``); this layer never names a flow execution path.  A caller
that runs many steps binds the plan once (``executor_of``) and passes the
``BoundExecutor`` as ``plan``, so no step re-resolves a backend.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.attention import BoundExecutor, ExecutionPlan, init_state
from repro_torch.config import ModelConfig
from repro_torch.core.flow_attention import FlowConfig
from repro_torch.kernels.gather import paged_gather, paged_gather_quant
from repro_torch.layers import mixer as mixer_lib
from repro_torch.layers.linear import dense, dense_init
from repro_torch.layers.rope import apply_rope
from repro_torch.serving import quant as quant_lib
from repro_torch.serving.paged import PagedKVCache, PagedSpec, pages_for
from repro_torch.utils import resolve_device

_PORTED = ("flow", "softmax")


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Hkv, L, D)
    v: torch.Tensor  # (B, Hkv, L, Dv)
    pos: torch.Tensor  # (B,) int32 -- tokens written per slot


def _require_ported(cfg: ModelConfig):
    if cfg.attention.kind not in _PORTED or cfg.mla is not None:
        raise NotImplementedError(
            f"attention kind {cfg.attention.kind!r}"
            + (" with MLA" if cfg.mla is not None else "")
            + " is not ported yet (flow and softmax attention only)")


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
            state_dtype: str | None = None) -> ExecutionPlan:
    """Build the model-level ``ExecutionPlan`` once; ``flow`` comes from
    ``cfg.attention``; ``paged`` a ``PagedSpec`` for softmax KV caches
    (layers that cannot page serve unpaged); ``needs_grad`` for a
    training step; ``state_dtype`` the serving state pools' dtype (None,
    "bf16" and "fp32" keep the fp32 FlowState and set the KV caches'
    dtype, "int8" and "fp8" quantize every pool).  The plan's
    ``speculate_k`` is the serving ``Engine``'s to set."""
    return ExecutionPlan(flow=flow_cfg_of(cfg, causal), packed=packed,
                         paged=paged, needs_grad=needs_grad,
                         state_dtype=state_dtype)


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
    _require_ported(cfg)
    d, hd = cfg.d_model, cfg.dim_head
    nq, nkv = cfg.n_heads, cfg.kv_heads
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
    raise NotImplementedError(f"rope={cfg.rope!r} is not ported yet")


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig, positions):
    """Per-head q, k, v with positional encoding applied."""
    q = _split_heads(dense(params["wq"], x), cfg.n_heads)
    k = _split_heads(dense(params["wk"], x), cfg.kv_heads)
    v = _split_heads(dense(params["wv"], x), cfg.kv_heads)
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


def attention(params, x: torch.Tensor, cfg: ModelConfig, *, causal: bool,
              positions=None, plan: ExecutionPlan | BoundExecutor | None = None):
    """Full-sequence attention.  x: (B, N, d_model)."""
    _require_ported(cfg)
    q, k, v = _project_qkv(params, x, cfg, positions)
    if cfg.attention.kind == "flow":
        out = _flow_executor(cfg, causal, plan).forward(q, k, v)
    else:
        out = _softmax_attn(q, k, v, causal=causal,
                            softcap=cfg.attention.softcap)
    return dense(params["wo"], _merge_heads(out))


def _attn_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, *, paged: PagedSpec | None = None,
                     device="cuda"):
    """Decode cache for one layer on ``device`` (the card unless the caller
    asks for the CPU): the O(d^2) FlowState, fp32, for flow; for softmax a
    dense ``KVCache`` of ``max_len`` positions in ``dtype``, or with
    ``paged`` a ``PagedKVCache`` of ``paged.num_pages`` pages (0: the
    dense-equivalent ``batch * ceil(max_len / page_size)``) plus the trash
    page."""
    _require_ported(cfg)
    dev = resolve_device(device)
    hd, nkv = cfg.dim_head, cfg.kv_heads
    if cfg.attention.kind == "flow":
        return init_state(batch, nkv, hd, hd, device=dev)
    pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if paged is not None:
        p = paged.num_pages or batch * pages_for(max_len, paged.page_size)
        shape = (p + 1, nkv, paged.page_size, hd)
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
    softmax a dense ``KVCache`` padded to ``max_len`` in the activation
    dtype, ``pos`` = ``lengths`` (or N)."""
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
    pool = cache if isinstance(cache, quant_lib.QuantizedPool) else None
    store = pool.payload if pool is not None else cache
    if isinstance(store, PagedKVCache):
        return _paged_decode(params, q, k, v, cache, cfg, page_table)
    # dense: each slot writes at its own position, clamped to the cache's
    # end; then attend over the first kv_len positions
    t = store.pos
    cache_len = store.k.shape[2]
    rows = torch.arange(x.shape[0], device=x.device)
    idx = t.clamp(max=cache_len - 1).long()
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
    ``cfg.attention.kind`` switches the mechanism."""

    params_field = "attn"

    def packable(self, cfg):
        return True, "per-row boundary caches from one padded causal call"

    def paged_capable(self, cfg):
        if cfg.mla is not None:
            return False, ("MLA keeps its compressed dense latent cache "
                           "(~an order smaller than raw KV)")
        if cfg.attention.kind == "softmax":
            return True, "dense KV cache pages into the pool"
        if cfg.attention.kind == "local":
            return False, "bounded ring buffer (nothing to page)"
        return False, "constant-size O(d^2) recurrent state (nothing to page)"

    def verify_capable(self, cfg):
        kind = cfg.attention.kind
        if kind == "local":
            return False, ("ring buffer overwrites history: a rejected "
                           "draft cannot be rolled back")
        if kind == "flow":
            return True, ("registry verify op: one carry-in pass, "
                          "trajectory FlowState rollback")
        if kind == "linear":
            return True, "trajectory rollback over sequential decode"
        return True, ("positional cache: rollback is per-slot position "
                      "arithmetic (stale writes are masked, then "
                      "overwritten)")

    def quant_capable(self, cfg, platform, dtype):
        ok, why = quant_lib.platform_support(dtype, platform)
        if not ok:
            return False, why
        if cfg.attention.kind == "flow":
            return True, f"quantized FlowState pool ({why})"
        return True, f"per-token quantized KV rows ({why})"

    def init_params(self, gen, cfg):
        return attn_init(gen, cfg)

    def forward(self, params, x, cfg, *, positions=None, plan=None):
        return attention(params, x, cfg, causal=True, positions=positions,
                         plan=plan)

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
            _attn_cache_init(cfg, batch, max_len, cache_dtype, paged=paged,
                             device=device), plan)

    def prefill(self, params, x, cfg, max_len, *, positions=None,
                lengths=None, plan=None):
        return _attention_prefill(params, x, cfg, max_len,
                                  positions=positions, lengths=lengths,
                                  plan=plan)

    def decode_step(self, params, x, state, cfg, *, positions=None,
                    page_table=None, plan=None):
        return _attention_decode(params, x, state, cfg, positions=positions,
                                 page_table=page_table, plan=plan)

    def verify_step(self, params, x, state, cfg, *, positions=None,
                    page_table=None, plan=None):
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
        # softmax, dense or paged: a positional cache rolls back by its
        # position, so decode the window token by token and keep only the
        # final cache (n snapshots of the cache would cost n x its bytes)
        out, states = self.decode_window(params, x, state, cfg,
                                         positions=positions,
                                         page_table=page_table, plan=plan)
        return out, states[-1]

    def select_verified(self, pending, accepted, n, cfg, *, plan=None):
        if isinstance(pending, quant_lib.QuantTraj):
            # gather the accepted fp32 boundary first, then quantize: the
            # rollback's single requantization
            return pending.quantize(mixer_lib.select_from_trajectory(
                pending.traj, accepted))
        if cfg.attention.kind == "flow":
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


mixer_lib.register_mixer("attn", AttentionMixer())
