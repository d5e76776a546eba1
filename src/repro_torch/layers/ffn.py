"""Feed-forward block (GELU, the flowformer_lm activation)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.linear import dense, dense_init


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, act: str) -> dict:
    if act != "gelu":
        raise NotImplementedError(f"act={act!r} is not ported yet (gelu only)")
    return {"w_in": dense_init(gen, d_model, d_ff),
            "w_out": dense_init(gen, d_ff, d_model)}


def ffn(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act != "gelu":
        raise NotImplementedError(f"act={act!r} is not ported yet (gelu only)")
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(dense(params["w_in"], x), approximate="tanh")
    return dense(params["w_out"], h)
