"""Whisper-style encoder-decoder backbone (the conv frontend is a stub).

The counterpart of ``repro/models/encdec.py``.  The encoder takes
precomputed frame embeddings (B, N_enc, d_model), adds learned absolute
positions (``enc_pos``) and runs pre-norm blocks of non-causal flow
attention and an FFN.  The decoder runs, per block, strict-causal
self-attention with rope, then cross-attention: non-causal flow attention
with N != M (queries from the decoder, keys and values from the encoder's
memory), the rectangular case of the paper's Eq. 4.  Parameters are a
plain dict with the reference's tree

    {"embed": {"table"}, "enc_pos": {"table"}, "encoder": [per-layer
     dicts], "enc_norm", "decoder": [per-layer dicts], "final_norm",
     "head": {"table"}}

On a GPU the encoder's attention is kernel K6 (K7b in its backward), the
decoder's self-attention K1 (K2 in its backward) and the cross-attention
K6 (K7b).  Serving: ``init_dec_caches`` makes the decoder's FlowState
pools; ``decode_step`` advances them with K3 and treats the new token as
the single sink of a fresh non-causal pair against the memory (K6 at one
sink row), as the reference does.

Each entry point takes ``plan``: an ``ExecutionPlan`` (or None) that
``executors`` binds, once per call, into the causal and the non-causal
``BoundExecutor``; or those ``Executors`` themselves, bound once by a
caller that runs many steps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.attention import BoundExecutor, ExecutionPlan
from repro_torch.config import ModelConfig
from repro_torch.layers.attention import attention, attn_init, executor_of
from repro_torch.layers.embeddings import embed, embedding_init, unembed
from repro_torch.layers.ffn import ffn, ffn_init
from repro_torch.layers.mixer import resolve_mixer
from repro_torch.layers.norms import apply_norm, norm_init
from repro_torch.layers.rope import default_positions
from repro_torch.utils import resolve_device, tree_map


class Executors(NamedTuple):
    """The two attention executors of the model, bound once."""

    causal: BoundExecutor  # the decoder's self-attention
    nc: BoundExecutor  # the encoder's self-attention and cross-attention


def executors(cfg: ModelConfig, plan=None) -> Executors:
    """Bind ``plan`` (an ``ExecutionPlan``, None for the default, or
    ``Executors`` as they are) for both attention directions."""
    if isinstance(plan, Executors):
        return plan
    return Executors(executor_of(cfg, plan, causal=True),
                     executor_of(cfg, plan, causal=False))


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters with the reference's tree, shapes and initializer
    families, drawn on the CPU from ``generator`` and moved to
    ``device``."""
    dev = resolve_device(device)
    d = cfg.d_model

    def enc_layer():
        return {"norm1": norm_init(d, cfg.norm),
                "attn": attn_init(generator, cfg),
                "norm2": norm_init(d, cfg.norm),
                "ffn": ffn_init(generator, d, cfg.d_ff, cfg.act)}

    def dec_layer():
        return {"norm1": norm_init(d, cfg.norm),
                "self_attn": attn_init(generator, cfg),
                "norm_x": norm_init(d, cfg.norm),
                "cross_attn": attn_init(generator, cfg),
                "norm2": norm_init(d, cfg.norm),
                "ffn": ffn_init(generator, d, cfg.d_ff, cfg.act)}

    n_enc = cfg.n_encoder_layers or cfg.n_layers
    p = {"embed": embedding_init(generator, cfg.vocab_size, d),
         "enc_pos": embedding_init(generator, cfg.max_seq_len, d),
         "encoder": [enc_layer() for _ in range(n_enc)],
         "enc_norm": norm_init(d, cfg.norm),
         "decoder": [dec_layer() for _ in range(cfg.n_layers)],
         "final_norm": norm_init(d, cfg.norm),
         "head": embedding_init(generator, cfg.vocab_size, d)}
    return tree_map(lambda x: x.to(dev), p)


def encode(params, frames: torch.Tensor, cfg: ModelConfig, *,
           dtype=torch.bfloat16, plan=None) -> torch.Tensor:
    """frames: (B, N_enc, d_model) stub embeddings -> memory (B, N_enc,
    d_model) in ``dtype``."""
    ex = executors(cfg, plan)
    n = frames.shape[1]
    x = frames.to(dtype) + params["enc_pos"]["table"][:n].to(dtype)[None]
    for bp in params["encoder"]:
        h = apply_norm(bp["norm1"], x, cfg.norm)
        x = x + attention(bp["attn"], h, cfg, causal=cfg.encoder_causal,
                          plan=ex.causal if cfg.encoder_causal else ex.nc)
        x = x + ffn(bp["ffn"], apply_norm(bp["norm2"], x, cfg.norm), cfg.act)
    return apply_norm(params["enc_norm"], x, cfg.norm)


def _cross_ffn(bp, x, memory, cfg: ModelConfig, ex: Executors):
    """A decoder block's cross-attention and FFN, each with its residual."""
    h = apply_norm(bp["norm_x"], x, cfg.norm)
    x = x + attention(bp["cross_attn"], h, cfg, causal=False,
                      kv_input=memory, plan=ex.nc)
    return x + ffn(bp["ffn"], apply_norm(bp["norm2"], x, cfg.norm), cfg.act)


def decode_train(params, tokens: torch.Tensor, memory: torch.Tensor,
                 cfg: ModelConfig, *, dtype=torch.bfloat16,
                 plan=None) -> torch.Tensor:
    """Teacher-forced decoder pass.  tokens: (B, N_dec) int; memory: (B,
    M, d_model) -> logits (B, N_dec, vocab) fp32."""
    ex = executors(cfg, plan)
    b, n = tokens.shape
    x = embed(params["embed"], tokens, dtype)
    positions = default_positions(b, n, device=tokens.device)
    for bp in params["decoder"]:
        h = apply_norm(bp["norm1"], x, cfg.norm)
        x = x + attention(bp["self_attn"], h, cfg, causal=True,
                          positions=positions, plan=ex.causal)
        x = _cross_ffn(bp, x, memory, cfg, ex)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(params["head"], x, softcap=cfg.logit_softcap)


def forward(params, batch_inputs, cfg: ModelConfig, *, dtype=torch.bfloat16,
            plan=None):
    """batch_inputs: (frames, dec_tokens) -> (logits, aux loss 0.0)."""
    ex = executors(cfg, plan)
    frames, dec_tokens = batch_inputs
    memory = encode(params, frames, cfg, dtype=dtype, plan=ex)
    logits = decode_train(params, dec_tokens, memory, cfg, dtype=dtype,
                          plan=ex)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(params, batch: dict, cfg: ModelConfig, *, dtype=torch.bfloat16,
            plan=None):
    """batch: {"frames" (B, N_enc, d_model), "inputs" (B, N_dec) tokens,
    "targets" (B, N_dec) int, "mask" optional}.  Returns (loss, metrics):
    the mean next-token cross-entropy over the mask."""
    logits, aux = forward(params, (batch["frames"], batch["inputs"]), cfg,
                          dtype=dtype, plan=plan)
    targets = batch["targets"].long()
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    ce = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    metrics = {"loss": ce, "ce": ce, "aux": aux,
               "ppl": torch.exp(ce.clamp(max=20.0)), "tokens": mask.sum()}
    return ce, metrics


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def init_dec_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                    plan: ExecutionPlan | None = None,
                    device="cuda") -> list:
    """The decoder self-attention's decode states, one ``{"self": pool}``
    per decoder layer, made by the attention mixer's ``state_init`` on
    ``device`` (the card unless the caller asks for the CPU)."""
    platform = resolve_device(device).type
    mx = resolve_mixer("attn", cfg, plan, platform)
    return [{"self": mx.state_init(cfg, batch, max_len, device=device,
                                   plan=plan)} for _ in range(cfg.n_layers)]


def decode_step(params, token: torch.Tensor, memory: torch.Tensor, caches,
                cfg: ModelConfig, pos, *, dtype=torch.bfloat16, plan=None):
    """One autoregressive decoder step.  token: (B, 1) int; pos: int or
    (B,) position of this token.  Returns (logits (B, 1, vocab), caches);
    on the GPU the FlowStates are the given ones updated in place."""
    ex = executors(cfg, plan)
    b = token.shape[0]
    x = embed(params["embed"], token, dtype)
    positions = default_positions(b, 1, pos, device=token.device)
    mx = resolve_mixer("attn", cfg)
    new_caches = []
    for bp, cache in zip(params["decoder"], caches):
        h = apply_norm(bp["norm1"], x, cfg.norm)
        y, self_cache = mx.decode_step(bp["self_attn"], h, cache["self"], cfg,
                                       positions=positions, plan=ex.causal)
        # cross-attention: this token is the single sink of a fresh
        # non-causal pair against the memory (n = 1 in Eq. 4)
        x = _cross_ffn(bp, x + y, memory, cfg, ex)
        new_caches.append({"self": self_cache})
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(params["head"], x, softcap=cfg.logit_softcap), new_caches


def greedy_decode(params, memory: torch.Tensor, start: torch.Tensor,
                  cfg: ModelConfig, steps: int, *, dtype=torch.bfloat16,
                  plan=None):
    """Greedy decoding from fresh caches: ``start`` (B, P) int prompt
    tokens are fed one by one, then ``steps`` tokens are chosen by argmax
    and fed back.  Returns (tokens (B, steps) int, logits (B, P - 1 +
    steps, vocab) fp32: the logits after each fed token, the last of
    which chose the last token)."""
    ex = executors(cfg, plan)
    b, p = start.shape
    caches = init_dec_caches(cfg, b, p + steps, plan=ex.causal.plan,
                             device=memory.device)
    tok, chosen, seen = start[:, :1], [], []
    for t in range(p + steps - 1):
        logits, caches = decode_step(params, tok, memory, caches, cfg, t,
                                     dtype=dtype, plan=ex)
        seen.append(logits)
        if t + 1 < p:
            tok = start[:, t + 1:t + 2]
        else:
            tok = logits.argmax(-1).to(start.dtype)
            chosen.append(tok)
    return torch.cat(chosen, dim=1), torch.cat(seen, dim=1)
