"""Device-resident serving data plane: packed prefill + batched decode/sample.

The counterpart of ``repro/serving/worker.py`` for the port.  The
``Worker`` owns the parameters and the slot-batched pool of per-layer
decode states (a ``FlowState`` per flow layer, an ``SSDState`` per SSD
layer), and two device computations:

* ``prefill`` — packed admission: every prompt of the admission batch is
  right-padded into one (R, Lb) prefill (``lm.prefill(..., lengths=)``),
  the per-row boundary states are written into their slots, and the first
  tokens are sampled for the whole batch.
* ``step`` — one decode of every slot (on a GPU the flow layers resolve to
  the ``flow_decode`` kernel, which updates the pool in place; the SSD
  layers run the plain recurrence and return new states) and one batched
  sample.  The only host transfer per step is the sampled token
  vector.

With ``state_dtype="int8"`` every layer's pool is a ``QuantizedPool``
(``serving/quant.py``): int8 payloads plus fp32 per-(slot, head) scales.
Admission quantizes each batch's fp32 boundary states once and scatters
payload and scale into the slots; on a GPU each decode step runs the
``flow_decode_q`` kernel (K4) on the pool in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.attention import ExecutionPlan
from repro_torch.config import ModelConfig
from repro_torch.layers.attention import executor_of
from repro_torch.models import lm
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


def _bucket_len(n: int, max_len: int) -> int:
    """Pad admission batches to power-of-two buckets from 8 up to max_len."""
    b = 8
    while b < n:
        b *= 2
    return max(min(b, max_len), n)


def _install_layer(dst, src, slot_ids: torch.Tensor):
    """Write an admission batch's boundary states into their pool slots,
    in place: every tensor of the state tree (a FlowState, t included, or
    an SSDState with its tuple of conv histories), recursing through
    tuples and NamedTuples as the reference's generic branch does.  A
    quantized pool takes the batch's fp32 states quantized ONCE with its
    recipe (fresh per-(row, head) scales), payload and scale scattered
    alike, so the pool's tensors never move."""
    if isinstance(dst, QuantizedPool):
        src = quantize_like(dst, src)
        _install_layer(dst.payload, src.payload, slot_ids)
        _install_layer(dst.scale, src.scale, slot_ids)
    elif isinstance(dst, torch.Tensor):
        dst[slot_ids] = src.to(dst.dtype)
    else:
        for d, s in zip(dst, src, strict=True):
            _install_layer(d, s, slot_ids)


class Worker:
    """The device data plane: params plus the slot-batched state pool."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int, max_len: int,
                 seed: int = 0, plan: ExecutionPlan | None = None,
                 dtype=torch.bfloat16, state_dtype: str | None = None,
                 device="cuda"):
        """Move the parameters to ``device`` and build the state pool.

        ``dtype`` is the serving activation dtype (fp32 makes generations
        comparable token for token with an fp32 reference); the flow state
        is fp32 whatever it is, unless ``state_dtype`` (which outranks the
        plan's) is "int8": then every pool is an int8 ``QuantizedPool``.
        ``device`` defaults to ``"cuda"`` and raises when no GPU is
        present; pass ``"cpu"`` for the plain PyTorch versions.
        """
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.dtype = dtype
        self.params = lm.for_serving(params, self.device, dtype)
        # bound once: every admission and step reuses the resolved backends
        base = plan or ExecutionPlan()
        self.executor = executor_of(cfg, dataclasses.replace(
            base, packed=True, state_dtype=state_dtype
            if state_dtype is not None else base.state_dtype))
        #: the serving plan every admission and step runs under
        self.plan = self.executor.plan
        self.caches = lm.init_caches(cfg, slots, max_len, plan=self.executor,
                                     device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        #: admission rounds (packed prefills) and decode steps run so far
        self.admission_rounds = 0
        self.decode_steps = 0

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def prefill(self, prompts: list[np.ndarray], slot_ids: list[int],
                temps: np.ndarray) -> np.ndarray:
        """Admit a batch of prompts into ``slot_ids``; return their first
        sampled tokens (one host transfer for the whole batch)."""
        lens = [len(p) for p in prompts]
        lb = _bucket_len(max(lens), self.max_len)
        toks = np.zeros((len(prompts), lb), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        with torch.inference_mode():
            logits, new = lm.prefill(
                self.params, self._tensor(toks, torch.int32), self.cfg,
                max_len=lb, lengths=self._tensor(lens, torch.int32),
                plan=self.executor, dtype=self.dtype)
            ids = self._tensor(slot_ids, torch.long)
            for dst, src in zip(self.caches, new):
                _install_layer(dst, src, ids)
            t = self._tensor(temps, torch.float32)
            first = sample_tokens(self._gen if (temps > 0).any() else None,
                                  logits, t, torch.ones_like(t, dtype=torch.bool))
        self.admission_rounds += 1
        return first.cpu().numpy()

    def step(self, tokens: np.ndarray, pos: np.ndarray, temps: np.ndarray,
             live: np.ndarray) -> np.ndarray:
        """One decode of every slot, live or not, and one batched sample."""
        with torch.inference_mode():
            logits, self.caches = lm.decode(
                self.params, self._tensor(tokens, torch.int32)[:, None],
                self.caches, self.cfg, self._tensor(pos, torch.int32),
                plan=self.executor, dtype=self.dtype)
            toks = sample_tokens(self._gen if (temps > 0).any() else None,
                                 logits, self._tensor(temps, torch.float32),
                                 self._tensor(live, torch.bool))
        self.decode_steps += 1
        return toks.cpu().numpy()
