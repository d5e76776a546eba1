"""Token embeddings and the output head."""
from __future__ import annotations

import torch

from repro_torch.utils import trunc_normal


def embedding_init(gen: torch.Generator, vocab: int, d: int) -> dict:
    return {"table": trunc_normal(gen, (vocab, d), stddev=0.02)}


def embed(params: dict, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return params["table"][ids.long()].to(dtype)


def unembed(params: dict, x: torch.Tensor, *, softcap: float = 0.0):
    """Project hidden states to vocab logits (fp32 out): the products of
    activation-dtype values, summed in fp32."""
    w = params["table"].to(x.dtype)
    logits = torch.matmul(x.float(), w.float().t())
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
