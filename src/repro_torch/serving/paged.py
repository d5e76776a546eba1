"""Paged KV allocation for softmax-mode serving baselines.

The counterpart of ``repro/serving/paged.py``.  Flow-Attention's O(d^2)
state needs none of this; the softmax baseline's dense
``(slots, Hkv, max_len, D)`` cache per layer does, and this module gives
it the PagedAttention-style pool:

* ``PagedKVCache`` -- K/V live in a pool of fixed-size pages shared by
  all slots; a slot's logical cache is the sequence of pages its
  page-table row names.
* ``PageAllocator`` -- host-side page table and free list.  Admission maps
  a request's whole span (prompt + decode budget), retirement returns the
  pages, so resident bytes track committed tokens.

Unmapped table entries hold the sentinel ``num_pages``, as in the
reference.  One deliberate difference of layout: the pool holds one page
more than it hands out, a trash page at index ``num_pages``.  JAX's
``.at[...].set`` drops out-of-range indices, and the reference relies on
that for writes from dead slots and padded install positions; PyTorch's
``index_put_`` raises on them instead (a device-side assert on CUDA).  So
every sentinel write here lands in the trash page, which the allocator
never hands out and no gather reads (gathers see the first ``num_pages``
pages and clamp sentinels into them, as the reference's do).  Writes to it
need no host-side filtering and cannot collide with a live page.
``serving.quant.pool_bytes`` counts the trash page apart
(``trash_bytes``).  One table serves every layer; each layer owns its pool.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Paged-cache geometry for a softmax-mode engine.

    ``num_pages == 0`` sizes the pool to the dense-equivalent worst case
    (``slots * ceil(max_len / page_size)``).  A smaller pool turns
    admission into real allocation: the engine reserves each request's
    whole prompt + budget span at admission, so requests wait in the queue
    when the pool is tight and a request that could never fit fails fast.
    """

    page_size: int = 64
    num_pages: int = 0


class PagedKVCache(NamedTuple):
    """One layer's paged K/V pool, indexed by (page, head, offset).  The
    last page is the trash page (see the module docstring)."""

    k: torch.Tensor  # (P + 1, Hkv, page_size, D)
    v: torch.Tensor  # (P + 1, Hkv, page_size, Dv)
    pos: torch.Tensor  # (S,) int32 -- tokens written per slot


def pages_for(tokens: int, page_size: int) -> int:
    return -(-tokens // page_size)


class PageAllocator:
    """Host-side free list + page table (sentinel ``num_pages`` = unmapped)."""

    def __init__(self, spec: PagedSpec, slots: int, max_len: int):
        self.page_size = spec.page_size
        self.pages_per_slot = pages_for(max_len, spec.page_size)
        self.num_pages = spec.num_pages or slots * self.pages_per_slot
        self.sentinel = self.num_pages
        self.free: list[int] = list(range(self.num_pages - 1, -1, -1))
        self.table = np.full((slots, self.pages_per_slot), self.sentinel,
                             np.int32)
        self.mapped = np.zeros(slots, np.int64)  # pages mapped per slot

    def can_admit(self, length: int) -> bool:
        return len(self.free) >= pages_for(max(length, 1), self.page_size)

    def admit(self, slot: int, length: int):
        """Map pages for a ``length``-token span into ``slot`` (the engine
        passes prompt + decode budget so decode never allocates)."""
        self.release(slot)
        need = pages_for(max(length, 1), self.page_size)
        if len(self.free) < need:
            raise RuntimeError(
                f"paged KV pool exhausted: need {need} pages for slot {slot}, "
                f"{len(self.free)} free of {self.num_pages}")
        for j in range(need):
            self.table[slot, j] = self.free.pop()
        self.mapped[slot] = need

    def ensure(self, slot: int, upto_pos: int):
        """Guarantee a mapped page for writing position ``upto_pos`` (a
        safety net: admission's full-span reservation normally makes this
        a no-op).  A slot at its row capacity stops growing: the device
        write then clamps into the last page, as the dense cache's
        end-of-cache clamp does."""
        while (self.mapped[slot] < self.pages_per_slot
               and self.mapped[slot] * self.page_size <= upto_pos):
            if not self.free:
                raise RuntimeError(
                    f"paged KV pool exhausted mid-decode at slot {slot} "
                    f"position {upto_pos} ({self.num_pages} pages total)")
            self.table[slot, self.mapped[slot]] = self.free.pop()
            self.mapped[slot] += 1

    def release(self, slot: int):
        """Return a slot's pages to the free list (request retirement)."""
        n = int(self.mapped[slot])
        for j in range(n):
            self.free.append(int(self.table[slot, j]))
        self.table[slot, :] = self.sentinel
        self.mapped[slot] = 0

    def install_indices(self, slots: list[int], lengths: list[int],
                        padded_len: int):
        """(page_ids, offsets), each (R, padded_len), for scattering the
        prompt K/V of freshly admitted slots into the pools; positions at
        or beyond a row's length point at the sentinel (the trash page)."""
        r = len(slots)
        pids = np.full((r, padded_len), self.sentinel, np.int32)
        offs = np.zeros((r, padded_len), np.int32)
        for i, (slot, length) in enumerate(zip(slots, lengths)):
            idx = np.arange(length)
            pids[i, :length] = self.table[slot, idx // self.page_size]
            offs[i, :length] = idx % self.page_size
        return pids, offs

    @property
    def free_pages(self) -> int:
        return len(self.free)
