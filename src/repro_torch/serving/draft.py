"""Draft sources for speculative decoding.

The counterpart of ``repro/serving/draft.py``.  A ``DraftSource``
proposes ``k`` candidate tokens per slot each engine iteration; the
target ``Worker`` then scores the whole window in one fused ``verify``
(``lm.verify`` through the attention registry's ``verify`` op) and
commits the accepted prefix plus a bonus or correction token.  Each
window is two device calls' worth of work, propose and verify, instead of
one decode per token.

Two sources ship:

* ``SelfDraft``: the target drafts for itself with ``k`` greedy decode
  steps from a copy of the worker's flow states.  The decode kernels
  (K3, and K4 on int8 pools) update a FlowState pool in place, so the
  propose clones those constant-size pools first (the reference's jit
  copies them by not donating them); the real pools never move.  The
  positional KV pools of softmax layers stay shared: the draft writes
  rows ``pos .. pos + k - 1``, verify rewrites rows ``pos .. pos + k``
  with the same tokens before it reads any of them, and the ``pos``
  rewind of the rollback masks the tail.  The SSD decode returns new
  states and leaves its input alone, so SSD pools are shared too.
* ``ModelDraft``: a separate, usually much smaller drafter with its own
  slot-batched pool kept in lockstep with the target: admitted prompts are
  prefilled into the draft pool, each propose records the drafter's state
  after every step (a clone: the drafter's decode also updates in place),
  and ``commit`` gathers the state at the target's accepted boundary, so
  the drafter consumes exactly the committed token stream.  ``tiny_draft``
  builds a smoke-sized ``flowformer_lm`` drafter.

Greedy parity does not depend on the draft source: every committed token
comes from the target's own verify logits, so speculative greedy decoding
emits token for token what plain greedy decoding would.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.attention.recurrent import FlowState
from repro_torch.layers.mixer import select_from_trajectory, stack_trajectory
from repro_torch.models import lm
from repro_torch.serving.quant import QuantizedPool

__all__ = ["DraftSource", "ModelDraft", "SelfDraft", "tiny_draft"]


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, -1].float().argmax(dim=-1).to(torch.int32)[:, None]


def _private_copy(cache):
    """A layer's cache with its in-place-updated pool cloned: a FlowState,
    or the payload and scales of a quantized one.  Positional KV pools and
    SSD states are returned as they are (see the module docstring)."""
    if isinstance(cache, FlowState):
        return FlowState(*(t.clone() for t in cache))
    if isinstance(cache, QuantizedPool) and isinstance(cache.payload,
                                                       FlowState):
        return cache.with_state(_private_copy(cache.payload),
                                _private_copy(cache.scale))
    return cache


class DraftSource:
    """The lifecycle the engine drives; subclass and override.

    ``install(worker, k)`` binds the source to the target worker's slot
    pool before serving; each iteration the engine calls ``propose``, then
    after the target's verify ``commit``; ``admit`` and ``release`` mirror
    slot admission and retirement for sources with per-slot state.
    """

    def install(self, worker, k: int):
        """Bind to the target ``Worker`` (slot count, config, dtype)."""
        self.worker = worker
        self.k = k

    def admit(self, prompts: list[np.ndarray], slot_ids: list[int]):
        """A batch of prompts was admitted into ``slot_ids``."""

    def propose(self, tokens: np.ndarray, pos: np.ndarray,
                live: np.ndarray) -> np.ndarray:
        """Draft ``(slots, k)`` candidate tokens continuing each slot.

        ``tokens`` (S,) is each slot's last committed token at absolute
        position ``pos`` (S,); dead slots may return garbage.
        """
        raise NotImplementedError

    def commit(self, accepted: np.ndarray, live: np.ndarray):
        """The target accepted ``accepted[i] + 1`` window tokens per slot."""

    def release(self, slot: int):
        """A slot retired; drop any per-slot draft state."""


class SelfDraft(DraftSource):
    """Self-speculation: k greedy decode steps from a copy of the worker's
    flow states.

    Stateless between windows: every propose restarts from the worker's
    committed caches, so there is no commit or rollback to get wrong.
    Exact for greedy slots: the drafts are the target's own greedy
    continuation, so verify accepts all k and every window commits k + 1
    tokens.
    """

    def propose(self, tokens, pos, live):
        w = self.worker
        table = None
        if w.allocator is not None:
            # the draft decodes write K/V at pos .. pos + k - 1: map those
            # pages so the reads gather real context
            for slot in np.flatnonzero(live):
                w.allocator.ensure(int(slot), int(pos[slot]) + self.k - 1)
            table = w._tensor(w.allocator.table, torch.int32)
        drafts = []
        with torch.inference_mode():
            caches = [_private_copy(c) for c in w.caches]
            tok = w._tensor(tokens, torch.int32)[:, None]
            p = w._tensor(pos, torch.int32)
            for _ in range(self.k):
                logits, caches = lm.decode(w.params, tok, caches, w.cfg, p,
                                           page_table=table, plan=w.executor,
                                           dtype=w.dtype)
                tok = _greedy(logits)
                drafts.append(tok)
                p = p + 1
            out = torch.cat(drafts, dim=1).cpu().numpy()
        return out  # the propose's one transfer to the host


class ModelDraft(DraftSource):
    """A separate drafter model with its own slot-batched pool.

    ``admit`` prefills prompts into the draft pool, ``propose`` runs
    ``k + 1`` greedy steps and records the drafter's state after each,
    and ``commit`` gathers the state at the target's accepted boundary:
    the drafter's feed ``[last, d_1 .. d_a]`` is the target's committed
    window, so the pools never drift.  Constant-size decode states make
    the recorded trajectory cheap.  The drafter runs in fp32.
    """

    def __init__(self, params, cfg):
        self.params = params
        self.cfg = cfg
        self._pending = None

    def install(self, worker, k: int):
        from repro_torch.serving.worker import Worker

        super().install(worker, k)
        self.pool = Worker(self.params, self.cfg, slots=worker.slots,
                           max_len=worker.max_len, dtype=torch.float32,
                           device=worker.device)

    def admit(self, prompts, slot_ids):
        # the draft pool samples its own (discarded) first tokens; the
        # committed first token arrives as ``tokens`` at the next propose
        self.pool.prefill(prompts, slot_ids,
                          np.zeros(len(prompts), np.float32))

    def propose(self, tokens, pos, live):
        pool = self.pool
        drafts, traj = [], []
        with torch.inference_mode():
            caches = pool.caches
            tok = pool._tensor(tokens, torch.int32)[:, None]
            p = pool._tensor(pos, torch.int32)
            # k + 1 steps: the k drafts plus the state past the whole
            # window, so commit can gather any accepted boundary in [0, k]
            for _ in range(self.k + 1):
                logits, caches = lm.decode(pool.params, tok, caches,
                                           pool.cfg, p, plan=pool.executor,
                                           dtype=pool.dtype)
                traj.append([_private_copy(c) for c in caches])
                tok = _greedy(logits)
                drafts.append(tok)
                p = p + 1
            self._pending = [stack_trajectory(list(layer))
                             for layer in zip(*traj)]
            out = torch.cat(drafts[:self.k], dim=1).cpu().numpy()
        return out  # the propose's one transfer to the host

    def commit(self, accepted, live):
        if self._pending is None:
            return
        acc = self.pool._tensor(accepted, torch.long)
        with torch.inference_mode():
            self.pool.caches = [select_from_trajectory(layer, acc)
                                for layer in self._pending]
        self._pending = None


def tiny_draft(cfg, *, seed: int = 0) -> ModelDraft:
    """A smoke-sized ``flowformer_lm`` drafter matched to ``cfg``'s vocab
    and ``max_seq_len``, with random weights from ``seed`` (for plumbing
    tests and as a starting point: train or distill it for real
    acceptance rates)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config

    dcfg = dataclasses.replace(get_smoke_config("flowformer_lm"),
                               vocab_size=cfg.vocab_size,
                               max_seq_len=cfg.max_seq_len)
    params = lm.init(dcfg, torch.Generator().manual_seed(seed), device="cpu")
    return ModelDraft(params, dcfg)
