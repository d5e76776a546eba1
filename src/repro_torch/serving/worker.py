"""Device-resident serving data plane: packed prefill + batched decode/sample.

The counterpart of ``repro/serving/worker.py`` for the port.  The
``Worker`` owns the parameters and the slot-batched pool of per-layer
decode states (a ``FlowState`` per flow layer, a ``KVCache`` or a paged
``PagedKVCache`` pool per softmax layer, an ``SSDState`` per SSD layer),
and two device computations:

* ``prefill`` — packed admission: every prompt of the admission batch is
  right-padded into one (R, Lb) prefill (``lm.prefill(..., lengths=)``),
  the per-row boundary states are written into their slots, and the first
  tokens are sampled for the whole batch.  A stack with a layer that
  cannot pack (``stack_capabilities``' ``packable``: local attention
  rings) admits one request at a time instead, as the reference does:
  one prefill of the prompt alone, installed into its slot, and one host
  transfer a request.
* ``step`` — one decode of every slot (on a GPU the flow layers resolve to
  the ``flow_decode`` kernel, which updates the pool in place; the SSD
  layers run the plain recurrence and return new states) and one batched
  sample.  The only host transfer per step is the sampled token
  vector.

With ``state_dtype="int8"`` every layer's pool is a ``QuantizedPool``
(``serving/quant.py``): int8 payloads plus fp32 per-(slot, head) scales.
Admission quantizes each batch's fp32 boundary states once and scatters
payload and scale into the slots; on a GPU each decode step runs the
``flow_decode_q`` kernel (K4) on the pool in place.  A slot migrating
between fleet workers (``serving/transport.py``) installs through the
same scatter, an int8 one verbatim, payload and scales unrequantized.

``verify`` is the speculative window's step: one ``lm.verify`` scores
each slot's last committed token and its k drafted candidates in one
pass, the accepted prefix is chosen on the device (greedy prefix match,
or rejection sampling at temperature > 0), one batched draw gives each
slot's bonus or correction token, and ``lm.select_verified`` rolls every
layer back to the accepted boundary.  Its only host transfer is the
emitted tokens with the accepted counts.

With ``paged=PagedSpec(...)`` a softmax stack's KV caches live in page
pools (``serving/paged.py``): the host-side ``PageAllocator`` maps each
admitted request's whole span, admission flattens the dense prefill
cache into the slots' pages (an int8 pool quantizes it once there), and
each step sends the page table to the device with the tokens, one small
host-to-device copy; every layer's decode then gathers its slots' pages
(K8a, or K8b on int8 pools).  A stack with no pageable layer serves
unpaged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.attention import ExecutionPlan
from repro_torch.config import ModelConfig
from repro_torch.layers.attention import KVCache, executor_of
from repro_torch.layers.mixer import stack_capabilities
from repro_torch.models import lm
from repro_torch.serving.paged import (PageAllocator, PagedKVCache, PagedSpec,
                                       pages_for)
from repro_torch.serving.quant import QuantizedPool, quantize_like
from repro_torch.utils import resolve_device


def sample_tokens(gen: torch.Generator | None, logits: torch.Tensor,
                  temps: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """One device-side draw for the whole slot batch.

    logits: (S, V) or (S, 1, V); temps: (S,), greedy where <= 0; live:
    (S,) bool.  Greedy rows take the argmax; with a generator, rows with
    temperature > 0 draw from softmax(logits / T).  Dead rows give 0.
    """
    if logits.ndim == 3:
        logits = logits[:, -1]
    logits = logits.float()
    tok = logits.argmax(dim=-1)
    if gen is not None:
        hot = temps > 0
        scaled = logits / torch.where(hot, temps, 1.0)[:, None]
        drawn = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                  generator=gen)[:, 0]
        tok = torch.where(hot, drawn, tok)
    return torch.where(live, tok, 0).to(torch.int32)


def verify_tokens(gen: torch.Generator | None, logits: torch.Tensor,
                  toks: torch.Tensor, temps: torch.Tensor,
                  live: torch.Tensor):
    """Accept a prefix of each slot's drafts and draw its next token.

    logits: (S, n, V) verify logits, ``logits[:, j]`` scoring the token
    after ``toks[:, j]``; toks: (S, n) the last committed token then the
    n - 1 drafts; temps: (S,), greedy where <= 0; live: (S,) bool.
    Greedy slots accept the drafts that match the argmax, up to the first
    that does not.  Temperature slots accept draft j iff u_j < p(d_j),
    with p = softmax(logits / T): the draft sources propose greedily, a
    point mass, so the target probability is the whole threshold and the
    scheme samples the target distribution exactly.  Every slot then
    draws its bonus (all accepted) or correction token from the logits at
    its boundary, a rejecting temperature slot with the rejected draft
    masked out (the residual of a point-mass draft).  Returns (emitted
    (S, n): the accepted drafts, then the drawn token at index
    ``accepted``, zeros after and in dead slots; accepted (S,) int64).
    """
    logits = logits.float()
    n, vocab = logits.shape[1], logits.shape[2]
    drafts = toks[:, 1:].long()
    match = (logits[:, :-1].argmax(dim=-1) == drafts).long()
    accepted = match.cumprod(dim=1).sum(dim=1)  # (S,) in [0, n - 1]
    hot = temps > 0
    if gen is not None:
        tsafe = torch.where(hot, temps, 1.0)[:, None, None]
        probs = torch.softmax(logits[:, :-1] / tsafe, dim=-1)
        p_draft = probs.gather(-1, drafts[..., None])[..., 0]  # (S, n-1)
        u = torch.rand(drafts.shape, generator=gen, device=logits.device)
        acc_hot = (u < p_draft).long().cumprod(dim=1).sum(dim=1)
        accepted = torch.where(hot, acc_hot, accepted)
    at = accepted[:, None]
    bonus_logits = logits.gather(
        1, at[:, :, None].expand(-1, 1, vocab))[:, 0]  # (S, V)
    padded = torch.nn.functional.pad(drafts, (0, 1))
    rejected = padded.gather(1, at)  # (S, 1)
    cols = torch.arange(vocab, device=logits.device)[None, :]
    mask = (hot & (accepted < n - 1))[:, None] & (cols == rejected)
    bonus = sample_tokens(gen, bonus_logits.masked_fill(mask, -torch.inf),
                          temps, live)
    j = torch.arange(n, device=logits.device)[None, :]
    emitted = torch.where(j < at, padded, 0)
    emitted = torch.where(j == at, bonus[:, None].long(), emitted)
    emitted = torch.where(live[:, None], emitted, 0)
    return emitted.to(torch.int32), accepted


def _packable(cfg: ModelConfig, platform: str = "cuda") -> bool:
    """Can prompts be right-padded into one prefill call?  Every layer's
    mixer must be ``packable`` (per-row boundary states from one padded
    call)."""
    return stack_capabilities(cfg, platform)["packable"][0]


def _bucket_len(n: int, max_len: int) -> int:
    """Pad admission batches to power-of-two buckets from 8 up to max_len."""
    b = 8
    while b < n:
        b *= 2
    return max(min(b, max_len), n)


def _install_layer(dst, src, slot_ids: torch.Tensor, pids=None, offs=None):
    """Write an admission batch's boundary states into their pool slots,
    in place: every tensor of the state tree (a FlowState, t included, or
    an SSDState with its tuple of conv histories), recursing through
    tuples and NamedTuples as the reference's generic branch does.  A
    dense ``KVCache`` takes the batch's (R, Hkv, L, D) prefill caches into
    its first L positions; a ``PagedKVCache`` takes them flattened into
    pages by ``pids`` and ``offs`` (R, L) from ``install_indices``, whose
    padded positions point at the trash page.  A quantized pool takes a
    full-precision source quantized ONCE with its recipe (fresh
    per-(row, head) or per-token scales), and a source that is already a
    ``QuantizedPool`` (a migrating slot's bundle) verbatim; payload and
    scale are scattered alike, so the pool's tensors never move.  Source
    leaves may lie on another device (a bundle unpacked on the host):
    each is moved to its pool's device and dtype."""
    if isinstance(dst, QuantizedPool):
        if not isinstance(src, QuantizedPool):
            src = quantize_like(dst, src)
        _install_layer(dst.payload, src.payload, slot_ids, pids, offs)
        _install_layer(dst.scale, src.scale, slot_ids, pids, offs)
    elif isinstance(dst, PagedKVCache):
        n = src.k.shape[2]
        for d, s in ((dst.k, src.k), (dst.v, src.v)):
            d[pids[:, :n], :, offs[:, :n]] = s.transpose(1, 2).to(d.device,
                                                                  d.dtype)
        dst.pos[slot_ids] = src.pos.to(dst.pos.device, dst.pos.dtype)
    elif isinstance(dst, KVCache):
        n = src.k.shape[2]
        dst.k[slot_ids, :, :n] = src.k.to(dst.k.device, dst.k.dtype)
        dst.v[slot_ids, :, :n] = src.v.to(dst.v.device, dst.v.dtype)
        dst.pos[slot_ids] = src.pos.to(dst.pos.device, dst.pos.dtype)
    elif isinstance(dst, torch.Tensor):
        dst[slot_ids] = src.to(dst.device, dst.dtype)
    else:
        for d, s in zip(dst, src, strict=True):
            _install_layer(d, s, slot_ids, pids, offs)


class Worker:
    """The device data plane: params plus the slot-batched state pool."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int, max_len: int,
                 paged: PagedSpec | None = None, seed: int = 0,
                 plan: ExecutionPlan | None = None, dtype=torch.bfloat16,
                 state_dtype: str | None = None, device="cuda"):
        """Move the parameters to ``device`` and build the state pool.

        ``dtype`` is the serving activation dtype (fp32 makes generations
        comparable token for token with an fp32 reference), which KV
        caches follow; the flow state is fp32 whatever it is, unless
        ``state_dtype`` (which outranks the plan's) is "int8": then every
        pool is an int8 ``QuantizedPool``.  ``paged`` (or ``plan.paged``)
        pages the softmax KV caches when some layer can page.  ``device``
        defaults to ``"cuda"`` and raises when no GPU is present; pass
        ``"cpu"`` for the plain PyTorch versions.
        """
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.dtype = dtype
        self.params = lm.for_serving(params, self.device, dtype)
        base = plan or ExecutionPlan()
        paged = paged if paged is not None else base.paged
        pageable = stack_capabilities(cfg, self.device.type)["paged_capable"]
        #: the paged-pool spec, or None when unpaged (no pageable layer)
        self.paged = paged if (paged and pageable[0]) else None
        #: whether admission packs a batch into one prefill, or runs one
        #: prefill a request (a stack with a local attention ring)
        self.packable = _packable(cfg, self.device.type)
        # bound once: every admission and step reuses the resolved backends
        self.executor = executor_of(cfg, dataclasses.replace(
            base, packed=self.packable, paged=self.paged,
            state_dtype=state_dtype if state_dtype is not None
            else base.state_dtype))
        #: the serving plan every admission and step runs under
        self.plan = self.executor.plan
        #: the host-side page table and free list (paged pools only)
        self.allocator = (PageAllocator(self.paged, slots, max_len)
                          if self.paged else None)
        self.caches = lm.init_caches(cfg, slots, max_len, plan=self.executor,
                                     dtype=dtype, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        #: admission rounds (packed prefills, or one per request where the
        #: stack does not pack), decode steps and speculative verify
        #: windows run so far
        self.admission_rounds = 0
        self.decode_steps = 0
        self.verify_windows = 0

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def pages_needed(self, length: int) -> int:
        """Pages a ``length``-token span occupies (0 for unpaged pools)."""
        if self.allocator is None:
            return 0
        return pages_for(max(length, 1), self.allocator.page_size)

    @property
    def total_pages(self) -> int:
        """The paged pool's size in pages (0 for unpaged pools)."""
        return self.allocator.num_pages if self.allocator else 0

    def can_admit(self, length: int, reserved: int = 0) -> bool:
        """Whether the paged pool can take a ``length``-token reservation
        beyond the ``reserved`` pages already promised to earlier requests
        of the same admission batch."""
        return (self.allocator is None or self.allocator.free_pages
                >= reserved + self.pages_needed(length))

    def release_slot(self, slot: int):
        """Return a retired slot's pages to the free list (if paged)."""
        if self.allocator is not None:
            self.allocator.release(slot)

    def prefill(self, prompts: list[np.ndarray], slot_ids: list[int],
                temps: np.ndarray, *, spans: list[int] | None = None
                ) -> np.ndarray:
        """Admit a batch of prompts into ``slot_ids``; return their first
        sampled tokens (one host transfer for the whole batch).  ``spans``
        is each request's page reservation in tokens (prompt + decode
        budget; default the prompt): its pages are mapped up front, so an
        admitted request never exhausts the pool mid-decode."""
        lens = [len(p) for p in prompts]
        if self.allocator is not None:
            for slot, span in zip(slot_ids, spans or lens):
                self.allocator.admit(slot, span)
        if not self.packable:  # one prefill a request, at its own length
            return np.concatenate([
                self._admit([p], [slot], temps[i:i + 1], packed=False)
                for i, (p, slot) in enumerate(zip(prompts, slot_ids))])
        return self._admit(prompts, slot_ids, temps, packed=True)

    def _admit(self, prompts, slot_ids, temps, *, packed: bool) -> np.ndarray:
        """One prefill of ``prompts``, installed into ``slot_ids``, and their
        first tokens sampled; one host transfer.  Packed: right-padded to
        a bucket length with per-row ``lengths``; else one prompt at its
        own length with caches of ``max_len``, as the reference's fallback
        for stacks that cannot pack."""
        lens = [len(p) for p in prompts]
        lb = _bucket_len(max(lens), self.max_len) if packed else lens[0]
        pids = offs = None
        if self.allocator is not None:
            pids, offs = (self._tensor(a, torch.long) for a in
                          self.allocator.install_indices(
                              slot_ids, lens, lb if packed else self.max_len))
        toks = np.zeros((len(prompts), lb), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        with torch.inference_mode():
            logits, new = lm.prefill(
                self.params, self._tensor(toks, torch.int32), self.cfg,
                max_len=lb if packed else self.max_len,
                lengths=self._tensor(lens, torch.int32) if packed else None,
                plan=self.executor, dtype=self.dtype)
            ids = self._tensor(slot_ids, torch.long)
            for dst, src in zip(self.caches, new):
                _install_layer(dst, src, ids, pids, offs)
            t = self._tensor(temps, torch.float32)
            first = sample_tokens(self._gen if (temps > 0).any() else None,
                                  logits, t, torch.ones_like(t, dtype=torch.bool))
        self.admission_rounds += 1
        return first.cpu().numpy()

    def step(self, tokens: np.ndarray, pos: np.ndarray, temps: np.ndarray,
             live: np.ndarray) -> np.ndarray:
        """One decode of every slot, live or not, and one batched sample.
        A paged pool first maps any page a live slot's write needs."""
        table = None
        if self.allocator is not None:
            for slot in np.flatnonzero(live):
                self.allocator.ensure(int(slot), int(pos[slot]))
            table = self._tensor(self.allocator.table, torch.int32)
        with torch.inference_mode():
            logits, self.caches = lm.decode(
                self.params, self._tensor(tokens, torch.int32)[:, None],
                self.caches, self.cfg, self._tensor(pos, torch.int32),
                page_table=table, plan=self.executor, dtype=self.dtype)
            toks = sample_tokens(self._gen if (temps > 0).any() else None,
                                 logits, self._tensor(temps, torch.float32),
                                 self._tensor(live, torch.bool))
        self.decode_steps += 1
        return toks.cpu().numpy()

    def verify(self, tokens: np.ndarray, drafts: np.ndarray, pos: np.ndarray,
               temps: np.ndarray, live: np.ndarray):
        """One fused speculative verify and sample over the whole slot pool.

        tokens: (S,) each slot's last committed token; drafts: (S, k)
        drafted candidates; pos: (S,) the absolute position of ``tokens``.
        Returns ``(emitted (S, k + 1), accepted (S,))``: each live slot's
        committed window, its accepted drafts then the bonus or correction
        token at index ``accepted[i]``, with the caches already rolled
        back to that boundary.  One transfer to the host a window,
        whatever the slot count or k.  A paged pool first maps the pages
        of positions ``pos .. pos + k``, which the window writes.
        """
        k = drafts.shape[1]
        table = None
        if self.allocator is not None:
            for slot in np.flatnonzero(live):
                self.allocator.ensure(int(slot), int(pos[slot]) + k)
            table = self._tensor(self.allocator.table, torch.int32)
        toks = np.concatenate([np.asarray(tokens, np.int32)[:, None],
                               np.asarray(drafts, np.int32)], axis=1)
        with torch.inference_mode():
            toks_d = self._tensor(toks, torch.int32)
            logits, pending = lm.verify(
                self.params, toks_d, self.caches, self.cfg,
                self._tensor(pos, torch.int32), page_table=table,
                plan=self.executor, dtype=self.dtype)
            emitted, accepted = verify_tokens(
                self._gen if (temps > 0).any() else None, logits, toks_d,
                self._tensor(temps, torch.float32),
                self._tensor(live, torch.bool))
            self.caches = lm.select_verified(pending, accepted, k + 1,
                                             self.cfg, plan=self.executor)
            out = torch.cat([emitted, accepted[:, None].to(torch.int32)],
                            dim=1).cpu().numpy()
        self.verify_windows += 1
        return out[:, :-1], out[:, -1].astype(np.int64)
