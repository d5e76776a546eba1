"""Dense layers on plain parameter dicts; weights are (d_in, d_out)."""
from __future__ import annotations

import torch

from repro_torch.utils import lecun_normal


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> dict:
    return {"w": lecun_normal(gen, (d_in, d_out))}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the activation dtype (fp32 accumulation), cast back."""
    return torch.matmul(x, params["w"].to(x.dtype))
