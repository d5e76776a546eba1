"""Fleet serving: disaggregated prefill/decode workers over portable state.

The counterpart of ``repro/serving/fleet.py``.  The single-device
``Engine`` pairs one ``Scheduler`` with one ``Worker``.  At fleet scale
the two halves of serving want different hardware shapes: prefill is a
throughput-bound batch job, decode a latency-bound resident one.
``FleetEngine`` splits them: a **prefill group** of workers that run
packed admission and emit per-request boundary states, and a **decode
group** that holds resident slot pools, with the ``Scheduler`` re-cast
as a fleet router: one global FIFO queue in front, one slot table a
decode worker behind it.

What makes this cheap for flow stacks is the paper's serving claim made
operational: the flow decode state is a constant O(d^2) blob per (layer,
head), so a request's whole serving context serializes into a
:class:`~repro_torch.serving.transport.StateBundle` whose size does not
grow with its context.  The router moves bundles through
``StateTransport`` for three jobs:

* **admission hand-off**: a prefill worker packs queued prompts into one
  prefill, and each request's boundary state is exported and installed
  into the least-loaded decode worker's slot pool;
* **rebalancing**: when the live-slot skew between decode workers
  exceeds ``rebalance_skew``, the most recently admitted requests
  migrate off the hot worker before the next step (they lose no decode
  step);
* **failover**: ``kill_worker`` loses a decode worker and its pools.
  Each orphan is re-installed from its retained bundle and the tokens
  committed since are replayed (the same decode computation the lost
  worker ran), or, with ``replicate=False``, its committed stream is
  prefilled again on a prefill worker.

Greedy output equals the single ``Engine``'s: every committed token is an
argmax of the same model over the same committed stream, and bundles
install through the scatter packed admission uses.  The two parts that
are the port's own: the parameters are cast for serving once per device
and every worker on that device shares that one copy (three workers of
``prefill:1,decode:2`` on one card hold one copy of the weights), and a
killed worker's pools are dropped with it.  Speculative windows stay a
single-``Engine`` feature, as in the reference.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.launch.mesh import make_fleet_meshes
from repro_torch.models import lm
from repro_torch.serving.paged import PagedSpec
from repro_torch.serving.scheduler import Request, Scheduler, budget_met
from repro_torch.serving.transport import StateBundle, StateTransport
from repro_torch.serving.worker import Worker

__all__ = ["FleetEngine"]


@dataclasses.dataclass
class _Member:
    """One decode worker plus its host-side slot table."""

    worker: Worker | None
    scheduler: Scheduler
    alive: bool = True

    @property
    def load(self) -> int:
        return sum(r is not None for r in self.scheduler.active)


class FleetEngine:
    """Router over prefill and decode worker groups (Engine-compatible).

    ``prefill``/``decode`` size the two groups; ``slots`` is the pool
    width of each decode worker (and the packed-admission width of each
    prefill worker).  ``rebalance_skew``/``rebalance_max`` tune the
    migration policy (the live-slot skew tolerated; the requests moved a
    step at most).  ``replicate=True`` retains each request's last
    exported bundle, so failover re-installs and replays instead of
    prefilling again.  ``devices`` (names or ``torch.device``s) are carved
    into the two groups by ``make_fleet_meshes``; ``None`` means every
    CUDA device, and raises when there is none.  ``dtype`` is the serving
    activation dtype (default bf16), ``state_dtype`` the pools' (as
    ``Engine``'s).  Plain decode only.
    """

    def __init__(self, params, cfg: ModelConfig, *, prefill: int = 1,
                 decode: int = 2, slots: int = 4, max_len: int = 4096,
                 seed: int = 0, paged: PagedSpec | bool | None = None,
                 plan=None, dtype=None, state_dtype: str | None = None,
                 rebalance_skew: int = 2, rebalance_max: int = 2,
                 replicate: bool = True, devices=None):
        if prefill < 1 or decode < 1:
            raise ValueError("a fleet needs at least one prefill and one "
                             f"decode worker (got {prefill}/{decode})")
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.rebalance_skew = rebalance_skew
        self.rebalance_max = rebalance_max
        self.replicate = replicate
        if paged is True:
            paged = PagedSpec()
        dtype = torch.bfloat16 if dtype is None else dtype
        self.prefill_devices, self.decode_devices = make_fleet_meshes(
            prefill, decode, devices=devices)
        served: dict[torch.device, dict] = {}

        def worker(dev, worker_seed):
            # one serving cast of the weights a device, shared by its
            # workers (Worker's own for_serving is then a no-op)
            if dev not in served:
                served[dev] = lm.for_serving(params, dev, dtype)
            return Worker(served[dev], cfg, slots=slots, max_len=max_len,
                          paged=paged or None, seed=worker_seed, plan=plan,
                          dtype=dtype, state_dtype=state_dtype, device=dev)

        pdevs, ddevs = self.prefill_devices, self.decode_devices
        self.prefills = [worker(pdevs[i % len(pdevs)], seed)
                         for i in range(prefill)]
        self.members = [_Member(worker(ddevs[i % len(ddevs)], seed + 1 + i),
                                Scheduler(slots))
                        for i in range(decode)]
        self.transport = StateTransport()
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        #: uid -> last exported bundle (admission or migration boundary)
        self.replicas: dict[int, StateBundle] = {}
        self._admit_seq: dict[int, int] = {}
        self._seq = 0
        self._rr = 0  # round-robin cursor over the prefill group
        # migration accounting
        self.migrations = 0
        self.recoveries = 0
        self.bytes_migrated = 0
        self.kb_by_uid: dict[int, float] = {}

    # -- facade conveniences --------------------------------------------
    @property
    def workers(self) -> list[Worker | None]:
        """Decode-group workers, index-aligned with ``kill_worker``
        (``None`` for a killed one)."""
        return [m.worker for m in self.members]

    def locate(self, uid: int) -> tuple[int, int] | None:
        """(decode worker index, slot) currently holding request ``uid``."""
        for i, m in enumerate(self.members):
            if not m.alive:
                continue
            for s, r in enumerate(m.scheduler.active):
                if r is not None and r.uid == uid:
                    return i, s
        return None

    def loads(self) -> list[int]:
        """Live slots per decode worker (-1 for dead members)."""
        return [m.load if m.alive else -1 for m in self.members]

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        """Enqueue a request on the global FIFO."""
        self.queue.append(req)

    def _span(self, req: Request) -> int:
        # the request's total consumed tokens at retirement (prompt +
        # budget - 1: the last generated token is never consumed)
        return min(len(req.prompt) + req.max_new_tokens - 1, self.max_len)

    def _stream(self, req: Request) -> np.ndarray:
        """The committed token stream a resumed request must re-consume."""
        if not req.generated:
            return np.asarray(req.prompt, np.int32)
        return np.concatenate([np.asarray(req.prompt, np.int32),
                               np.asarray(req.generated[:-1], np.int32)])

    def _retire(self, req: Request):
        req.done = True
        self.finished.append(req)
        self.replicas.pop(req.uid, None)

    def _pick_target(self, span: int, loads: dict[int, int],
                     free: dict[int, list[int]],
                     reserved: dict[int, int]) -> int | None:
        """Least-loaded live decode worker that can take a ``span`` row."""
        best = None
        for i, m in enumerate(self.members):
            if not m.alive or not free[i]:
                continue
            w = m.worker
            if (w.allocator is not None and w.allocator.free_pages
                    < reserved[i] + w.pages_needed(span)):
                continue
            if best is None or loads[i] < loads[best]:
                best = i
        return best

    def _credit(self, req: Request, bundle: StateBundle):
        self.kb_by_uid[req.uid] = (self.kb_by_uid.get(req.uid, 0.0)
                                   + bundle.kbytes)

    # ------------------------------------------------------------------
    def _admit(self):
        """Drain the global queue through packed prefill and bundle
        hand-off.

        Each round plans a batch (each request routed to the least-loaded
        decode worker with capacity), runs ONE packed prefill on the next
        prefill worker, then exports each request's boundary bundle and
        installs it into its decode slot.  A request whose budget is met
        by the prefill-sampled token retires without occupying a decode
        slot.  A resumed request (failover re-prefill, ``generated`` not
        empty) re-consumes its committed stream and drops the resampled
        token.  A span no decode pool can ever hold is refused loudly,
        without wedging the FIFO behind it.
        """
        while self.queue:
            if not any(m.alive for m in self.members):
                raise RuntimeError("fleet has no live decode workers")
            pw = self.prefills[self._rr % len(self.prefills)]
            loads = {i: m.load for i, m in enumerate(self.members)}
            free = {i: m.scheduler.free_slots()
                    for i, m in enumerate(self.members)}
            reserved = {i: 0 for i in range(len(self.members))}
            batch: list[Request] = []
            targets: list[tuple[int, int]] = []
            pw_reserved = 0
            while self.queue and len(batch) < pw.slots:
                req = self.queue[0]
                span = self._span(req)
                need = max(m.worker.pages_needed(span)
                           for m in self.members if m.alive)
                cap = max(m.worker.total_pages
                          for m in self.members if m.alive)
                if need > cap:
                    if batch:
                        break  # admit the collected batch; fail next round
                    self.queue.popleft()
                    self._retire(req)
                    raise ValueError(
                        f"request {req.uid}: span {span} needs {need} pages "
                        f"but the largest decode pool holds {cap}")
                plen = len(self._stream(req))
                mi = self._pick_target(span, loads, free, reserved)
                if mi is None or not pw.can_admit(plen, pw_reserved):
                    break  # no capacity: FIFO order holds, retry next step
                self.queue.popleft()
                slot = free[mi].pop(0)
                loads[mi] += 1
                reserved[mi] += self.members[mi].worker.pages_needed(span)
                pw_reserved += pw.pages_needed(plen)
                batch.append(req)
                targets.append((mi, slot))
            if not batch:
                return
            self._rr += 1
            streams = [self._stream(r) for r in batch]
            tslots = list(range(len(batch)))
            temps = np.array([r.temperature for r in batch], np.float32)
            first = pw.prefill(streams, tslots, temps,
                               spans=[len(s) for s in streams])
            for req, tslot, (mi, slot), stream in zip(batch, tslots, targets,
                                                      streams):
                if not req.generated:
                    tok = int(first[tslot])
                    req.generated.append(tok)
                    if budget_met(req, tok):
                        # the decode slot was never consumed: retire now
                        self._retire(req)
                        pw.release_slot(tslot)
                        continue
                bundle = self.transport.export(pw, tslot, len(stream))
                pw.release_slot(tslot)
                m = self.members[mi]
                self.transport.install(m.worker, slot, bundle,
                                       span=self._span(req))
                m.scheduler.adopt(slot, req, pos=len(stream))
                self._seq += 1
                self._admit_seq[req.uid] = self._seq
                if self.replicate:
                    self.replicas[req.uid] = bundle
                self._credit(req, bundle)

    # ------------------------------------------------------------------
    def _migrate(self, src: int, src_slot: int, dst: int, dst_slot: int):
        """Move one live request between decode workers mid-stream."""
        src_m, dst_m = self.members[src], self.members[dst]
        req = src_m.scheduler.active[src_slot]
        pos = int(src_m.scheduler.pos[src_slot])
        bundle = self.transport.export(src_m.worker, src_slot, pos)
        src_m.scheduler.deactivate(src_slot)
        src_m.worker.release_slot(src_slot)
        self.transport.install(dst_m.worker, dst_slot, bundle,
                               span=self._span(req))
        dst_m.scheduler.adopt(dst_slot, req, pos=pos)
        if self.replicate:
            self.replicas[req.uid] = bundle
        self.migrations += 1
        self.bytes_migrated += bundle.nbytes
        self._credit(req, bundle)

    def migrate(self, uid: int, dst: int | None = None) -> int:
        """Migrate request ``uid`` to decode worker ``dst`` (or the least
        loaded other live worker).  Returns the bundle's wire bytes."""
        where = self.locate(uid)
        if where is None:
            raise ValueError(f"request {uid} is not live on any worker")
        src, src_slot = where
        if dst is None:
            others = [(m.load, i) for i, m in enumerate(self.members)
                      if m.alive and i != src and m.scheduler.free_slots()]
            if not others:
                raise RuntimeError("no live worker with a free slot to "
                                   f"migrate request {uid} to")
            dst = min(others)[1]
        dst_slot = self.members[dst].scheduler.free_slots()[0]
        before = self.bytes_migrated
        self._migrate(src, src_slot, dst, dst_slot)
        return self.bytes_migrated - before

    def _rebalance(self):
        """Migrate recent admits off a hot worker when skew exceeds policy."""
        alive = [i for i, m in enumerate(self.members) if m.alive]
        if len(alive) < 2:
            return
        hot = max(alive, key=lambda i: self.members[i].load)
        cold = min(alive, key=lambda i: self.members[i].load)
        skew = self.members[hot].load - self.members[cold].load
        if skew <= self.rebalance_skew:
            return
        n = min(self.rebalance_max, skew // 2)
        # most recently admitted first: they have the least decode
        # progress invested on the hot worker
        cands = sorted(
            ((self._admit_seq[r.uid], s)
             for s, r in enumerate(self.members[hot].scheduler.active)
             if r is not None), reverse=True)[:n]
        for _, slot in cands:
            free = self.members[cold].scheduler.free_slots()
            req = self.members[hot].scheduler.active[slot]
            w = self.members[cold].worker
            if not free or (w.allocator is not None
                            and not w.allocator.can_admit(self._span(req))):
                return
            self._migrate(hot, slot, cold, free[0])

    # ------------------------------------------------------------------
    def kill_worker(self, idx: int) -> list[int]:
        """Fault injection: lose decode worker ``idx`` and its device state.

        Its pools are dropped with it.  Orphaned requests are recovered
        onto survivors, in admission order: re-installed from their
        retained bundle plus a replay of the tokens committed since, or
        prefilled again when no bundle is retained.  Returns the recovered
        uids.
        """
        m = self.members[idx]
        if not m.alive:
            return []
        m.alive = False
        orphans = sorted((r for r in m.scheduler.active if r is not None),
                         key=lambda r: self._admit_seq[r.uid])
        m.worker = None  # the device state is gone: a later touch faults
        m.scheduler = Scheduler(self.slots)
        for req in orphans:
            self._recover(req)
        return [r.uid for r in orphans]

    def _replay(self, bundle: StateBundle, delta: np.ndarray) -> StateBundle:
        """Advance a retained bundle past the ``delta`` committed tokens.

        Runs on a prefill worker's transient slot 0: install, one decode
        step a token (the computation the lost worker ran, so the state is
        exact), export again.
        """
        if len(delta) == 0:
            return bundle
        pw = self.prefills[self._rr % len(self.prefills)]
        self._rr += 1
        self.transport.install(pw, 0, bundle,
                               span=bundle.length + len(delta))
        toks = np.zeros(pw.slots, np.int32)
        pos = np.zeros(pw.slots, np.int64)
        temps = np.zeros(pw.slots, np.float32)
        live = np.zeros(pw.slots, bool)
        live[0] = True
        pos[0] = bundle.length
        for tok in delta:
            toks[0] = tok
            pw.step(toks, pos, temps, live)  # the sampled token is dropped
            pos[0] += 1
        out = self.transport.export(pw, 0, int(pos[0]))
        pw.release_slot(0)
        return out

    def _recover(self, req: Request):
        """Re-home one orphaned request onto a surviving decode worker."""
        span = self._span(req)
        loads = {i: m.load for i, m in enumerate(self.members)}
        free = {i: m.scheduler.free_slots() if m.alive else []
                for i, m in enumerate(self.members)}
        mi = self._pick_target(span, loads, free,
                               {i: 0 for i in range(len(self.members))})
        if mi is None:
            # no capacity now: resume through the front of the admission
            # queue (FIFO order holds) by the re-prefill path
            self.replicas.pop(req.uid, None)
            self.queue.appendleft(req)
            return
        consumed = len(req.prompt) + len(req.generated) - 1
        bundle = self.replicas.get(req.uid)
        if bundle is not None:
            stream = np.concatenate([np.asarray(req.prompt, np.int32),
                                     np.asarray(req.generated, np.int32)])
            bundle = self._replay(bundle, stream[bundle.length:consumed])
        else:
            # a prefill of the whole committed stream on a prefill worker
            pw = self.prefills[self._rr % len(self.prefills)]
            self._rr += 1
            stream = self._stream(req)
            pw.prefill([stream], [0], np.zeros(1, np.float32),
                       spans=[len(stream)])
            bundle = self.transport.export(pw, 0, consumed)
            pw.release_slot(0)
        m = self.members[mi]
        slot = free[mi][0]
        self.transport.install(m.worker, slot, bundle, span=span)
        m.scheduler.adopt(slot, req, pos=consumed)
        if self.replicate:
            self.replicas[req.uid] = bundle
        self.recoveries += 1
        self.migrations += 1
        self.bytes_migrated += bundle.nbytes
        self._credit(req, bundle)

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One fleet iteration: admit, rebalance, then one decode and
        sample on every live decode worker with a live slot.  Returns the
        number of live slots stepped."""
        self._admit()
        self._rebalance()
        total = 0
        for m in self.members:
            if not m.alive:
                continue
            s = m.scheduler
            live = s.live_mask()
            n = int(live.sum())
            if n == 0:
                continue
            tokens = m.worker.step(s.last_tokens(), s.pos, s.temps, live)
            for slot in s.record_step(tokens, live):
                m.worker.release_slot(slot)
            for req in s.take_finished():
                self._retire(req)
            total += n
        return total

    def take_finished(self) -> list[Request]:
        """Drain retired requests, in retirement order."""
        out, self.finished = self.finished, []
        return out

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive the loop until every queued request retires (or
        ``max_steps``); drain and return the retired requests."""
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break
        return self.take_finished()
