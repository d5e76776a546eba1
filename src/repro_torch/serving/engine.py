"""Serving engine: continuous batching over constant-size flow states.

The counterpart of ``repro/serving/engine.py`` for this slice: plain
greedy or temperature decoding with packed admission and slot churn.
Every flow slot costs the same O(d^2) state whatever its context length,
so admission is a scatter into the slot pool and nothing is ever evicted.

``Engine`` is the thin facade over the host ``Scheduler`` (queue, slot
table, bookkeeping) and the device ``Worker`` (state pool, packed prefill,
batched decode and sample).  ``state_dtype="int8"`` serves from int8
pools (``serving/quant.py``).  Softmax-mode engines (KV caches) serve
through the same interface for the baseline comparison, and
``paged=PagedSpec(...)`` (or ``True``) moves their dense ``max_len``
caches into the page pool of ``serving/paged.py``: admission reserves
each request's whole span, waits in FIFO order while the pool is full,
and fails a request that could never fit without losing the requests
batched before it; retirement returns the pages.

``draft=`` and ``speculate_k=`` switch the loop to speculative decoding
(``serving/draft.py``): each iteration the draft source proposes k tokens
a slot and one fused ``Worker.verify`` commits each slot's accepted
prefix plus a bonus token, a variable number of tokens a step.  Greedy
generations equal plain decoding's token for token.  fp8 pools and the
per-request prefill fallback are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.serving.draft import DraftSource, SelfDraft, tiny_draft
from repro_torch.serving.paged import PagedSpec
from repro_torch.serving.scheduler import Request, Scheduler, budget_met
from repro_torch.serving.worker import Worker

__all__ = ["Engine", "PagedSpec", "Request"]


class Engine:
    """Single-device engine: ``submit`` requests, then ``step`` or ``run``."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 8,
                 max_len: int = 4096, seed: int = 0,
                 paged: PagedSpec | bool | None = None, plan=None,
                 dtype=torch.bfloat16, state_dtype: str | None = None,
                 draft: DraftSource | str | None = None,
                 speculate_k: int = 0, device="cuda"):
        """Build the scheduler/worker pair (and a draft source).  ``dtype``
        is the activation dtype; ``state_dtype`` the state pools' ("bf16"
        or "fp32" keep the fp32 FlowState and store KV caches in that
        width, "int8" stores int8 payloads with fp32 per-(slot, head) or
        per-token scales; fp8 is refused off the TPU).  ``paged`` (a
        ``PagedSpec``, or True for the default one) pages the softmax KV
        caches.  ``draft`` ("self", "tiny" or a ``DraftSource``) with
        ``speculate_k`` drafted tokens a window switches to speculative
        decoding: a draft without k gives k = 4, k without a draft gives
        "self".  ``device`` defaults to ``"cuda"`` and raises when no GPU
        is present; pass ``"cpu"`` to serve on the CPU with the plain
        PyTorch versions."""
        if draft is not None and speculate_k == 0:
            speculate_k = 4
        if speculate_k and draft is None:
            draft = "self"
        if paged is True:
            paged = PagedSpec()
        if speculate_k:
            # the Engine alone sets the plan's speculate_k; it makes mixer
            # resolution demand verify_capable when the pools are built, so
            # a stack that cannot verify fails here
            from repro_torch.layers.attention import plan_of

            plan = dataclasses.replace(plan or plan_of(cfg),
                                       speculate_k=speculate_k)
        self.max_len = max_len
        self.speculate_k = speculate_k
        self.scheduler = Scheduler(slots)
        self.worker = Worker(params, cfg, slots=slots, max_len=max_len,
                             paged=paged or None, seed=seed, plan=plan,
                             dtype=dtype, state_dtype=state_dtype,
                             device=device)
        if draft == "self":
            draft = SelfDraft()
        elif draft == "tiny":
            draft = tiny_draft(cfg, seed=seed)
        elif isinstance(draft, str):
            raise ValueError(f"unknown draft source {draft!r}: pass 'self', "
                             "'tiny' or a serving.draft.DraftSource")
        self.draft = draft
        if draft is not None:
            draft.install(self.worker, speculate_k)

    @property
    def queue(self):
        """The scheduler's FIFO admission queue."""
        return self.scheduler.queue

    @property
    def active(self):
        """The scheduler's slot table (``Request | None`` per slot)."""
        return self.scheduler.active

    def submit(self, req: Request):
        """Enqueue a request for admission on a future ``step()``."""
        self.scheduler.submit(req)

    def _admit(self):
        """Fill free slots from the queue.

        Each round is one packed prefill, one install and one batched
        first-token sample.  A paged pool reserves each request's whole
        span (prompt + decode budget + the ``speculate_k`` positions a
        verify window writes past the committed boundary, capped at
        ``max_len``): the round
        stops at the first request the pool cannot take now, which waits
        in FIFO order, and a request that can never fit is retired empty
        with a ``ValueError`` once the requests batched before it are
        admitted.  A request whose budget is met by its first token
        retires without occupying its slot (its pages go back), and the
        freed slot is offered to the queue again in the same call.
        """
        sched, worker = self.scheduler, self.worker
        while True:
            free = sched.free_slots()
            if not free or not sched.queue:
                return
            batch, spans, reserved = [], [], 0
            while sched.queue and len(batch) < len(free):
                req = sched.queue[0]
                span = min(len(req.prompt) + req.max_new_tokens - 1
                           + self.speculate_k, self.max_len)
                need = worker.pages_needed(span)
                if need > worker.total_pages:
                    if batch:
                        break  # admit the batch first; fail next round
                    sched.queue.popleft()
                    sched.retire(req)  # done, nothing generated
                    raise ValueError(
                        f"request {req.uid}: {len(req.prompt)} prompt + "
                        f"{req.max_new_tokens} budget tokens need {need} "
                        f"pages but the pool holds {worker.total_pages} "
                        "total")
                if not worker.can_admit(span, reserved):
                    break  # the pool is full: FIFO order holds, retry later
                reserved += need
                batch.append(sched.queue.popleft())
                spans.append(span)
            if not batch:
                return
            slot_ids = free[:len(batch)]
            temps = np.array([r.temperature for r in batch], np.float32)
            first = worker.prefill([r.prompt for r in batch], slot_ids,
                                   temps, spans=spans)
            if self.draft is not None:
                self.draft.admit([r.prompt for r in batch], slot_ids)
            for req, slot, tok in zip(batch, slot_ids, first):
                req.generated.append(int(tok))
                if budget_met(req, int(tok)):
                    sched.retire(req)
                    worker.release_slot(slot)
                else:
                    sched.activate(slot, req)

    def step(self) -> int:
        """One continuous-batching iteration; returns the number of live
        slots it decoded.  A plain engine decodes one token a live slot; a
        speculative one proposes, verifies and commits each slot's
        accepted prefix plus its bonus token."""
        self._admit()
        sched = self.scheduler
        live = sched.live_mask()
        n_live = int(live.sum())
        if n_live == 0:
            return 0
        if self.draft is None:
            tokens = self.worker.step(sched.last_tokens(), sched.pos,
                                      sched.temps, live)
            freed = sched.record_step(tokens, live)
        else:
            drafts = self.draft.propose(sched.last_tokens(), sched.pos, live)
            emitted, accepted = self.worker.verify(
                sched.last_tokens(), drafts, sched.pos, sched.temps, live)
            self.draft.commit(accepted, live)
            freed = sched.record_verify(emitted, accepted, live)
        for slot in freed:
            self.worker.release_slot(slot)
            if self.draft is not None:
                self.draft.release(slot)
        return n_live

    def take_finished(self) -> list[Request]:
        """Drain retired requests, in retirement order."""
        return self.scheduler.take_finished()

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive the loop until every queued request retires (or
        ``max_steps``); drain and return the retired requests."""
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break
        return self.take_finished()
