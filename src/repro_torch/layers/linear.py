"""Dense layers on plain parameter dicts; weights are (d_in, d_out)."""
from __future__ import annotations

import torch

from repro_torch.utils import lecun_normal


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False) -> dict:
    p = {"w": lecun_normal(gen, (d_in, d_out))}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32)
    return p


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the activation dtype with fp32 accumulation, plus the
    fp32 bias where there is one, rounded to the activation dtype once.
    With a bias the product runs on fp32 copies of the operands cast to
    the activation dtype: their products are exact in fp32, so the sum is
    the fp32 accumulator, and the bias joins it before the one rounding."""
    w = params["w"].to(x.dtype)
    if "b" not in params:
        return torch.matmul(x, w)
    y = torch.matmul(x.float(), w.float()) + params["b"].float()
    return y.to(x.dtype)
