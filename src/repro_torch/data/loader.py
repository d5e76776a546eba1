"""Step-indexed, host-shardable, exactly-resumable data iterators, copied
from ``repro/data/loader.py``.

An iterator's position is ``state() -> {"step": n}``; a
``DeterministicLoader`` built with ``start_step=n`` replays from the exact
next batch.  Host h of H draws rows [h::H] of every global batch, so the
global batch does not depend on the host count.  Batches are dicts of
numpy arrays.
"""
from __future__ import annotations

from typing import Callable, Iterator

from repro_torch.data.synthetic import zipf_text


class DeterministicLoader:
    def __init__(self, make_batch: Callable[[int], dict], *, start_step: int = 0,
                 host_id: int = 0, n_hosts: int = 1):
        """``make_batch(step) -> global batch dict of np arrays``."""
        self._make = make_batch
        self.step = start_step
        self.host_id = host_id
        self.n_hosts = n_hosts

    def state(self) -> dict:
        return {"step": self.step}

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        global_batch = self._make(self.step)
        self.step += 1
        if self.n_hosts == 1:
            return global_batch
        return {
            k: v[self.host_id :: self.n_hosts] for k, v in global_batch.items()
        }


def lm_loader(seed: int, *, batch: int, seq: int, vocab: int,
              start_step: int = 0, host_id: int = 0, n_hosts: int = 1
              ) -> DeterministicLoader:
    """Next-token batches {"inputs", "targets"} of (batch, seq) int32 from
    ``zipf_text``, one draw of batch * (seq + 1) tokens per step."""
    def make(step: int) -> dict:
        toks = zipf_text(seed * 1_000_003 + step, batch * (seq + 1), vocab)
        toks = toks.reshape(batch, seq + 1)
        return {"inputs": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()}

    return DeterministicLoader(make, start_step=start_step, host_id=host_id,
                               n_hosts=n_hosts)
