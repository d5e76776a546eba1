"""Token embeddings and the output head."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils import trunc_normal


def embedding_init(gen: torch.Generator, vocab: int, d: int) -> dict:
    return {"table": trunc_normal(gen, (vocab, d), stddev=0.02)}


def embed(params: dict, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of the table for ``ids``, cast to ``dtype``.  Through
    ``F.embedding``: the same gather as indexing, but its backward sums
    repeated ids by sorted segments, where an indexing gather's backward
    adds the rows of one id one after another (half of a classifier step
    on the H100, a padded batch being mostly one id)."""
    return F.embedding(ids.long(), params["table"]).to(dtype)


def unembed(params: dict, x: torch.Tensor, *, softcap: float = 0.0):
    """Project hidden states to vocab logits (fp32 out): the products of
    activation-dtype values, summed in fp32."""
    w = params["table"].to(x.dtype)
    logits = torch.matmul(x.float(), w.float().t())
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
