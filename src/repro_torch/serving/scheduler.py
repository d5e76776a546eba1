"""Host-side serving control plane: FIFO admission + retirement bookkeeping.

A copy of ``repro/serving/scheduler.py`` (numpy only), kept so that the
port imports nothing of the JAX package.  The ``Scheduler`` owns the
request queue, the slot table, per-request token lists, temperatures and
positions, and nothing that lives on the device; the ``Worker``
(``repro_torch/serving/worker.py``) owns the device state.  The scheduler
hands the worker flat numpy arrays (tokens, positions, temperatures, live
mask) and receives one numpy array of sampled tokens back per step.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request: prompt, budget, sampling knobs, results."""

    uid: int
    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: int | None = None  # retire early when this token is generated
    # filled by the engine:
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def budget_met(req: Request, tok: int) -> bool:
    """Did appending ``tok`` complete ``req``?  (budget or EOS reached)

    The single retirement predicate shared by the engine's admission
    path, the scheduler's step bookkeeping and the fleet router.
    """
    return (len(req.generated) >= req.max_new_tokens
            or (req.eos_id is not None and tok == req.eos_id))


class Scheduler:
    """FIFO queue + fixed-width slot table (pure host state)."""

    def __init__(self, slots: int):
        """Create the empty queue and a ``slots``-wide slot table."""
        self.slots = slots
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * slots
        self.finished: list[Request] = []
        self.pos = np.zeros(slots, np.int64)  # positions consumed per slot
        self.temps = np.zeros(slots, np.float32)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        """Append a request to the FIFO admission queue."""
        self.queue.append(req)

    def free_slots(self) -> list[int]:
        """Slot ids with no active request, in slot order."""
        return [i for i, r in enumerate(self.active) if r is None]

    def live_mask(self) -> np.ndarray:
        """(slots,) bool — which slots hold an active request."""
        return np.array([r is not None for r in self.active])

    def last_tokens(self) -> np.ndarray:
        """(slots,) int32 — each live slot's most recent token (0 if dead)."""
        tok = np.zeros(self.slots, np.int32)
        for i, r in enumerate(self.active):
            if r is not None:
                tok[i] = r.generated[-1]
        return tok

    # ------------------------------------------------------------------
    def activate(self, slot: int, req: Request):
        """Install an admitted request into ``slot`` (position, temp)."""
        self.adopt(slot, req, pos=len(req.prompt))

    def adopt(self, slot: int, req: Request, *, pos: int):
        """Install a request mid-stream at an explicit consumed position.

        The fleet router's migration/failover paths land requests whose
        state already consumed ``pos`` tokens (prompt + committed
        generations); plain admission is the ``pos == len(prompt)`` case.
        """
        self.active[slot] = req
        self.pos[slot] = pos
        self.temps[slot] = req.temperature

    def deactivate(self, slot: int):
        """Clear a slot WITHOUT retiring its request (migration source)."""
        self.active[slot] = None
        self.pos[slot] = 0
        self.temps[slot] = 0.0

    def retire(self, req: Request):
        """Mark a request done and move it to the finished list."""
        req.done = True
        self.finished.append(req)

    def record_step(self, tokens: np.ndarray, live: np.ndarray) -> list[int]:
        """Fold one decode step's sampled tokens into the bookkeeping.

        Appends per-slot tokens, advances positions, retires requests whose
        budget is met or whose ``eos_id`` was generated; returns the slot
        ids freed this step (the caller releases their device/page
        resources).
        """
        freed = []
        for i in np.flatnonzero(live):
            req = self.active[i]
            tok = int(tokens[i])
            req.generated.append(tok)
            self.pos[i] += 1
            if budget_met(req, tok):
                self.retire(req)
                self.active[i] = None
                freed.append(int(i))
        return freed

    def record_verify(self, emitted: np.ndarray, accepted: np.ndarray,
                      live: np.ndarray) -> list[int]:
        """Fold one speculative verify window into the bookkeeping.

        ``emitted`` (slots, n) holds each slot's committed window tokens —
        the accepted draft prefix followed by the verifier's bonus (or
        correction) token at index ``accepted[i]``; tokens past that index
        are dead padding.  Appends up to ``accepted[i] + 1`` tokens per
        live slot, truncating at the request budget or at ``eos_id``
        (either truncation retires the slot, so a surviving slot always
        consumed its full accepted prefix and host positions stay exactly
        in sync with the device caches: ``pos += accepted + 1``).  Returns
        the freed slot ids, like ``record_step``.
        """
        freed = []
        for i in np.flatnonzero(live):
            req = self.active[i]
            take = int(accepted[i]) + 1
            done = False
            for j in range(take):
                tok = int(emitted[i, j])
                req.generated.append(tok)
                if budget_met(req, tok):
                    done = True
                    break
            self.pos[i] += take
            if done:
                self.retire(req)
                self.active[i] = None
                freed.append(int(i))
        return freed

    def take_finished(self) -> list[Request]:
        """Drain and return the retired requests, in retirement order."""
        out, self.finished = self.finished, []
        return out
