"""Decoder-only language model (flow- and softmax-attention and Mamba-2
SSD stacks).

The counterpart of ``repro/models/lm.py`` for the stacks the port
serves: every layer is ``norm1 -> mixer -> residual``, followed by
``norm2 -> FFN -> residual`` where the config has an FFN and the mixer
wants one (``block_ffn``; an SSD block is the whole layer), with the
mixer resolved from ``cfg.block_kind`` through ``layers/mixer.py``.
Parameters are a plain dict of tensors

    {"embed": {"table"}, "blocks": [per-layer dicts], "final_norm", "head"}

(the JAX package's stacked ``scan`` layout is unstacked by
``interop.params_from_numpy``).  Dense weights are stored (d_in, d_out).

Entry points:
  init / forward / loss_fn            parameters, the full forward, the
                                      next-token loss (training)
  init_caches / prefill / decode      serving on per-layer decode states
  verify / select_verified            speculative decoding: score a drafted
                                      window in one pass, roll every layer
                                      back to the accepted prefix

With ``cfg.remat`` each block of a differentiated forward runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are recomputed
in the backward, as the reference's ``jax.checkpoint`` per block does.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.layers.embeddings import embed, embedding_init, unembed
from repro_torch.layers.ffn import ffn, ffn_init
from repro_torch.layers.mixer import get_mixer, resolve_mixers
from repro_torch.layers.norms import apply_norm, norm_init
from repro_torch.layers.rope import default_positions
from repro_torch.utils import resolve_device, tree_map


def _require_supported(cfg: ModelConfig):
    if cfg.moe is not None or cfg.rope == "mrope":
        raise NotImplementedError("MoE and mrope stacks are not ported yet")


def _block_init(gen: torch.Generator, kind: str, cfg: ModelConfig) -> dict:
    mx = get_mixer(kind)
    p = {"norm1": norm_init(cfg.d_model, cfg.norm),
         mx.params_field: mx.init_params(gen, cfg)}
    if cfg.d_ff > 0 and mx.block_ffn:
        p["norm2"] = norm_init(cfg.d_model, cfg.norm)
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.act)
    return p


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters with the reference's shapes and initializer
    families (truncated normal, std 0.02, for the tables; LeCun normal for
    dense weights), drawn on the CPU from ``generator`` and moved to
    ``device``."""
    _require_supported(cfg)
    dev = resolve_device(device)
    p = {"embed": embedding_init(generator, cfg.vocab_size, cfg.d_model),
         "blocks": [_block_init(generator, cfg.block_kind(i), cfg)
                    for i in range(cfg.n_layers)],
         "final_norm": norm_init(cfg.d_model, cfg.norm)}
    if not cfg.tie_embeddings:
        p["head"] = embedding_init(generator, cfg.vocab_size, cfg.d_model)
    return tree_map(lambda x: x.to(dev), p)


def for_serving(params: dict, device, dtype) -> dict:
    """``params`` on ``device`` with the matrices (tables and dense weights)
    stored in the activation ``dtype``.  Every matmul casts its weight to
    the activation dtype anyway, so this only moves the cast out of the
    loop; norm parameters stay fp32."""
    dev = resolve_device(device)
    return tree_map(lambda x: x.to(dev, dtype if x.ndim >= 2 else x.dtype),
                    params)


def _head(params, cfg: ModelConfig):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _ffn_residual(bp, x, cfg: ModelConfig):
    if "ffn" in bp:
        x = x + ffn(bp["ffn"], apply_norm(bp["norm2"], x, cfg.norm), cfg.act)
    return x


def _block(mx, bp, x, cfg: ModelConfig, positions, plan):
    h = apply_norm(bp["norm1"], x, cfg.norm)
    x = x + mx.forward(bp[mx.params_field], h, cfg, positions=positions,
                       plan=plan)
    return _ffn_residual(bp, x, cfg)


def forward(params, inputs: torch.Tensor, cfg: ModelConfig, *,
            positions=None, dtype=torch.bfloat16, plan=None):
    """inputs: int tokens (B, N).  Returns (logits (B, N, vocab) fp32,
    aux loss 0.0)."""
    _require_supported(cfg)
    b, n = inputs.shape
    x = embed(params["embed"], inputs, dtype)
    if positions is None:
        positions = default_positions(b, n, device=inputs.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for mx, bp in zip(resolve_mixers(cfg), params["blocks"]):
        if remat:
            x = checkpoint(_block, mx, bp, x, cfg, positions, plan,
                           use_reentrant=False)
        else:
            x = _block(mx, bp, x, cfg, positions, plan)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = unembed(_head(params, cfg), x, softcap=cfg.logit_softcap)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, batch: dict, cfg: ModelConfig, *, dtype=torch.bfloat16,
            plan=None):
    """batch: {"inputs": (B, N) tokens, "targets": (B, N) int, "mask":
    (B, N) optional}.  Returns (loss, metrics): the mean next-token
    cross-entropy over the mask, plus the aux loss."""
    logits, aux = forward(params, batch["inputs"], cfg, dtype=dtype,
                          positions=batch.get("positions"), plan=plan)
    targets = batch["targets"].long()
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    ce = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    loss = ce + aux
    metrics = {"loss": loss, "ce": ce, "aux": aux,
               "ppl": torch.exp(ce.clamp(max=20.0)), "tokens": mask.sum()}
    return loss, metrics


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *, plan=None,
                dtype=None, device="cuda") -> list:
    """Per-layer decode states on ``device`` (the card unless the caller
    asks for the CPU): a FlowState per flow layer, a ``KVCache`` per
    softmax layer (a ``PagedKVCache`` pool when ``plan.paged`` is set), an
    ``SSDState`` per SSD layer, or a ``QuantizedPool`` of one when
    ``plan`` (an ``ExecutionPlan`` or a ``BoundExecutor``) has an int8 or
    fp8 ``state_dtype``.  ``dtype`` is the serving activation dtype, which
    KV caches follow (default bf16) unless the plan's ``state_dtype`` is
    "bf16" or "fp32".  A layer whose mixer cannot meet the plan on
    ``device`` raises ``MixerResolutionError`` here."""
    platform = torch.device(device).type
    return [mx.state_init(cfg, batch, max_len, device=device, dtype=dtype,
                          plan=plan)
            for mx in resolve_mixers(cfg, plan, platform)]


def prefill(params, inputs: torch.Tensor, cfg: ModelConfig, max_len: int, *,
            dtype=torch.bfloat16, lengths=None, plan=None):
    """Consume a prompt; return (last-token logits (B, 1, vocab), caches).

    ``lengths`` (B,) packs right-padded prompts into one call: every layer
    is causal or position-wise, so padding never reaches true positions,
    each row's state lands at its own boundary, and the logits are taken
    at position ``lengths[i] - 1`` of each row.
    """
    _require_supported(cfg)
    b, n = inputs.shape
    x = embed(params["embed"], inputs, dtype)
    positions = default_positions(b, n, device=inputs.device)
    caches = []
    for mx, bp in zip(resolve_mixers(cfg), params["blocks"]):
        h = apply_norm(bp["norm1"], x, cfg.norm)
        y, cache = mx.prefill(bp[mx.params_field], h, cfg, max_len,
                              positions=positions, lengths=lengths, plan=plan)
        caches.append(cache)
        x = _ffn_residual(bp, x + y, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if lengths is None:
        x_last = x[:, -1:]
    else:  # each row's boundary token, not the padded tail
        li = lengths.to(device=x.device, dtype=torch.long).clamp(min=1) - 1
        x_last = x[torch.arange(b, device=x.device), li][:, None]
    return unembed(_head(params, cfg), x_last, softcap=cfg.logit_softcap), caches


def decode(params, token: torch.Tensor, caches: list, cfg: ModelConfig, pos,
           *, dtype=torch.bfloat16, page_table=None, plan=None):
    """One decode step.  token: (B, 1) int; pos: int or (B,) absolute
    position of this token per slot; ``page_table`` (B, pages_per_slot)
    int32 maps slots to pool pages when the caches are paged (one table
    serves every layer).  Returns (logits (B, 1, vocab), caches); on the
    GPU the FlowStates, and on every device the KV caches, are the given
    ones updated in place."""
    _require_supported(cfg)
    b = token.shape[0]
    x = embed(params["embed"], token, dtype)
    positions = default_positions(b, 1, pos, device=token.device)
    new_caches = []
    for mx, bp, state in zip(resolve_mixers(cfg), params["blocks"], caches):
        h = apply_norm(bp["norm1"], x, cfg.norm)
        y, cache = mx.decode_step(bp[mx.params_field], h, state, cfg,
                                  positions=positions, page_table=page_table,
                                  plan=plan)
        new_caches.append(cache)
        x = _ffn_residual(bp, x + y, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(_head(params, cfg), x, softcap=cfg.logit_softcap), new_caches


def verify(params, tokens: torch.Tensor, caches: list, cfg: ModelConfig,
           pos, *, dtype=torch.bfloat16, page_table=None, plan=None):
    """Score a drafted window of n tokens in one pass (speculative
    decoding).

    tokens: (B, n) int, the last committed token then the n - 1 drafted
    candidates; ``logits[:, j]`` scores the token at position
    ``pos + j + 1``, as n sequential ``decode`` calls would.  pos: int or
    (B,) absolute position of ``tokens[:, 0]`` per slot.  Returns (logits
    (B, n, vocab), pending): every layer's post-window verify state (a
    trajectory for constant-size states, the position-advanced cache for
    KV layers); ``select_verified`` commits the accepted prefix.  The flow
    layers' pools are only read; softmax layers write the window's K/V
    rows in place, as ``decode`` does.
    """
    _require_supported(cfg)
    b, n = tokens.shape
    x = embed(params["embed"], tokens, dtype)
    positions = default_positions(b, n, pos, device=tokens.device)
    pending = []
    for mx, bp, state in zip(resolve_mixers(cfg), params["blocks"], caches):
        h = apply_norm(bp["norm1"], x, cfg.norm)
        y, cache = mx.verify_step(bp[mx.params_field], h, state, cfg,
                                  positions=positions, page_table=page_table,
                                  plan=plan)
        pending.append(cache)
        x = _ffn_residual(bp, x + y, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(_head(params, cfg), x, softcap=cfg.logit_softcap), pending


def select_verified(pending: list, accepted: torch.Tensor, n: int,
                    cfg: ModelConfig, *, plan=None) -> list:
    """Roll every layer's pending verify state to the accepted prefix.

    accepted: (B,) int in [0, n - 1], the index of each row's last
    consumed window token (``accepted + 1`` tokens advance the state).
    Returns caches equal to having decoded only the accepted tokens.
    """
    return [mx.select_verified(p, accepted, n, cfg, plan=plan)
            for mx, p in zip(resolve_mixers(cfg), pending)]
